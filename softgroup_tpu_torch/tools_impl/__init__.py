"""Runners of the port (counterparts of ``softgroup_tpu/tools_impl``)."""
