"""Launchers of the port: ``serve`` (the sharded chain's serving launcher)."""
