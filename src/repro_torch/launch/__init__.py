"""Entry points of the port's LM serving and training paths."""
