"""Logging, profiler traces and canonical-form checks (ports of `sonic_tpu/utils/`)."""
