"""PyTorch + CUDA port of video_r2_tpu for NVIDIA Hopper (H100).

The JAX package ``video_r2_tpu`` stays the reference; every module here keeps
its counterpart's path and tensor layouts so tests can hold the two equal.
This package imports torch and never jax. Its paths: single-video QA on
Qwen2.5-VL from a video file (``apps/demo.py``, ``video/``), the eval harness
over the 11 think-mode benchmarks (``apps/run_eval.py``, ``evalharness/``),
LoRA SFT (``apps/train_sft.py``), GRPO with QLoRA over int8
(``apps/train_grpo.py``), batched serving through the paged engine
(``engine/continuous.py``), int4 / int8 serving (``models/quant.py``) and the
Qwen3-MoE judge (``engine/server.py``, ``rewards/judge.py``). Their kernels
are CUDA C++ under ``csrc/``, built at first use (``ops/cuda_build.py``).
Video decoding (cv2) and burn-in (PIL) run on the host, where those packages
are installed; decoded frames need neither.
"""
