"""The plain reference that decides ``correct``: plain PyTorch, with no
import of the program (``repro_torch``), of the JAX package or of JAX.

``hash`` is a frozen copy of the counter hash that defines every random
draw of a training run (initial topics, Gumbel noise, uniforms); ``lda``
works out counts and draws from the corpus and topics alone; ``compare``
turns the program's outputs and the reference's into the numbers that
are held to their limits.
"""
