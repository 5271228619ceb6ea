"""ZenLDA in PyTorch for one NVIDIA H100: a port of ``repro`` beside it.

It trains single-box (``train.session.TrainSession``, ``launch.train``)
with the ``zen`` (dense, plain torch) and ``zen_pallas`` backends, and
serves a trained model (``serving.LDAEngine``) in throughput mode (chain
CGS sweeps through a registry backend) and latency mode (RT-LDA).
``zen_pallas`` draws through four hand-written CUDA kernels: two for
training (``kernels/csrc/zen_train.cu``) and two for serving
(``kernels/csrc/zen_infer.cu``). The LM zoo's serving path is ported
too: ``models`` (every family of ``configs``) and ``serving.ServingEngine``.
The package imports torch, numpy and the standard library only.
"""
