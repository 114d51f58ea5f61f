"""LM architectures of the port: the serving path of every block kind
(dense, moe, rwkv, hymba), whisper's encoder-decoder and llava's image
tokens."""
