"""Namespace shard planning (the part of istio_tpu/sharding/ that Pilot
uses)."""
