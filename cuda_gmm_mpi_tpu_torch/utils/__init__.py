"""Support modules of the port: the sweep checkpointer and the logger."""
