"""Plain references, one module per configuration (``<config>.py``).

Each is written from its model's equations in plain PyTorch and NumPy and
imports nothing of the program (neither ``mamba_tpu_torch`` nor the JAX
package).  A module gives:

- ``make_data(config, seed)``: the configuration's data, made from the seed;
- ``BLOCK``: the gradient block's sites and their transforms;
- ``block_logp_grad(data, parts, values, dtype, device)``: the block's
  log-density and its gradient in unconstrained coordinates, for a batch of
  chains, in ``dtype``;
- ``monitored(data, values, dtype, device)``: the monitored scalars from
  the constrained state;
- ``in_support(label, x)``: which draws lie in the support;
- optionally ``gradient_flops(config, chains)``: the float32 work of one
  gradient evaluation of the model for all chains.
"""
