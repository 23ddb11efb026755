"""Launchers of the port: ``serve`` (LM serving, and the sharded chain's
serving launcher) and ``train`` (the training launcher)."""
