"""Operator tools of the port: ``deploy_cluster`` (the meta and store
daemons and the MySQL frontends), ``chaos_run``, ``importer``, ``backup``,
``flightrec`` (the flight-recorder viewer), ``metrics_export`` and the
``bench_*`` harnesses.  Each one's engine runs on the card unless told
``--device cpu``."""
