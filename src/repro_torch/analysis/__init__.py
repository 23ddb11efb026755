"""Machine-checkable contract annotations (``requires_lock``), the port's own
copy of what it needs from ``repro.analysis``."""
