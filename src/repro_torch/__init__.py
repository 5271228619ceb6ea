"""ZenLDA in PyTorch for one NVIDIA H100: a port of ``repro`` beside it.

This slice serves a trained model: ``serving.LDAEngine`` in throughput
mode (chain CGS sweeps through a registry backend) and latency mode
(RT-LDA), with the ``zen_pallas`` backend's frozen-model sampler as two
hand-written CUDA kernels (``kernels/csrc/zen_infer.cu``). Training is not
ported yet. The package imports torch, numpy and the standard library only.
"""
