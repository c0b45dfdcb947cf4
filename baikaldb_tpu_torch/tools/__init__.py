"""Operator tools of the port: ``deploy_cluster`` (the meta and store daemons)."""
