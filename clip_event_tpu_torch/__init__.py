"""PyTorch and CUDA port of clip_event_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths. Imports torch and numpy only: no
JAX and nothing of `clip_event_tpu`. Entry points run on the card
(`device="cuda"`) unless the caller passes `device="cpu"`.
"""
