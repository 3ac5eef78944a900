"""Serving: host-side block pool and the chunked-prefill engine."""
