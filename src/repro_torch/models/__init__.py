"""LM architectures of the port: the serving and training paths of every
block kind (dense, moe, rwkv, hymba), whisper's encoder-decoder and
llava's image tokens."""
