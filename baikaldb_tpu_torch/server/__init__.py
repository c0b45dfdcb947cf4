"""The MySQL frontend (server/mysql_server.py, ``python -m
baikaldb_tpu_torch.server``) and the store and meta daemons
(server/store_server.py, server/meta_server.py).

The port of ``baikaldb_tpu/server``.  This package's ``__init__`` imports
nothing: the daemons import no torch, and only the MySQL server loads the
engine."""
