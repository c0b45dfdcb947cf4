"""Data generators, one module a configuration family, found by the
``generator`` key of a configuration file: ``tables(config, seed)`` ->
{table name: pyarrow.Table}."""
