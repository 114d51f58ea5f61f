"""LM architectures of the port (the serving path of the dense and rwkv
blocks)."""
