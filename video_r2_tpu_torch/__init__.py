"""PyTorch + CUDA port of video_r2_tpu for NVIDIA Hopper (H100).

The JAX package ``video_r2_tpu`` stays the reference; every module here keeps
its counterpart's path and tensor layouts so tests can hold the two equal.
This package imports torch and never jax. Its slices: single-video QA on
Qwen2.5-VL (``apps/demo.py``), LoRA SFT (``apps/train_sft.py``), batched
serving through the paged engine (``engine/continuous.py``) and the
Qwen3-MoE judge (``engine/server.py``, ``rewards/judge.py``). Their kernels
are CUDA C++ under ``csrc/``, built at first use (``ops/cuda_build.py``).
"""
