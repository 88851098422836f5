"""Training: LoRA / full-parameter SFT (port of video_r2_tpu/train)."""
