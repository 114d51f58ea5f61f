"""Case configurations of the port."""
