"""Utilities (port of video_r2_tpu/utils)."""
