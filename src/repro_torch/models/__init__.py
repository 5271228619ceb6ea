"""The LM zoo (``repro/models``): norms, RoPE, attention (GQA, sliding
window, MLA), MoE, Mamba1/2 and the stacks of every family, as
``nn.Module``s whose parameter names follow the reference's pytree keys,
with the reference's public functions (``model.forward``,
``model.decode_step``, ...) as thin entry points."""
