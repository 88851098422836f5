"""Data of the PyTorch port (port of video_r2_tpu/data): the SFT and GRPO
datasets over LLaVA records, and the host prefetch loader."""
