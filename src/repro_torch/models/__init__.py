"""Model code of the port: the dense LM transformer (prefill and decode),
the recsys models and the GNNs (GIN, GAT, PNA, MACE). The MoE FFN is not
ported yet.

The package imports none of its modules: ``kernels.flash_attention`` takes
its plain version from ``models.attention``, and ``models.transformer``
calls the kernels, so importing the package must not pull in either side.
"""
