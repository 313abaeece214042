"""xmir_tpu_torch: the PyTorch + CUDA (Hopper) port of xmir_tpu.

It runs the gallery ingest -> exact top-k query path on an NVIDIA H100 with
DenseNet121, ConvNeXtV2-Base, DINOv2 ViT-B/14, SwinV2-Base and the CLIP-family
(MedSigLIP, ConceptCLIP, BiomedCLIP) embedders, every kernel the
JAX package wrote for the TPU on that path written by hand in CUDA
(``csrc/``: the fused similarity + top-k, the ConvNeXtV2 block tail, the
fused ViT attention and the LayerNorm -> projection kernels). The JAX package ``xmir_tpu`` is the reference it is held
against; this package imports neither JAX nor ``xmir_tpu``.
"""
