"""Training of the port: the train step and gradient compression."""
