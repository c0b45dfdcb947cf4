"""The store and meta daemons (server/store_server.py, server/meta_server.py).

The port of ``baikaldb_tpu/server``'s daemons; the MySQL server waits for
ROADMAP item 7."""
