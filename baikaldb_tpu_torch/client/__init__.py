"""The MySQL-protocol client (client/mysql_client.py)."""
