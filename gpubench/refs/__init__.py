"""Plain references, one module a configuration family, found by the
``reference`` key of a configuration file.  They import numpy and torch
only, never the program: each works its answers out again from the
generated tables the program was given.

A module gives ``Reference(config, tables, device)`` with
``answer(stmt, control=False)`` (rows as tuples; ``control=True`` computes
them in the precision one step below the configuration's, the control that
has to come out as not correct) and ``compare(stmt, got, want)`` (each
compared number of one statement), and ``NUMBERS``: each number's name and
how a run's statements combine it (``sum`` or ``max``)."""
