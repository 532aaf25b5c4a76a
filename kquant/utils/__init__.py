"""Utilities: roofline accounting, profiling harness, timing."""

from kquant.utils.roofline import model_bytes_per_token, roofline_report  # noqa: F401
