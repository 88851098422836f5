"""SFT data: LLaVA records -> masked-CE batches (port of video_r2_tpu/data)."""
