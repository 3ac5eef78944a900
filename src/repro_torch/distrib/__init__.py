"""Distributed serving attention over ``torch.distributed``: the
sequence- and block-sharded KV caches of ``decode_attn``."""
