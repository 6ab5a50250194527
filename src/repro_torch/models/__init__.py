"""Model code of the port: the LM transformer (training, prefill and
decode) with its dense MLP or MoE FFN, the recsys models and the GNNs
(GIN, GAT, PNA, MACE).

The package imports none of its modules: ``kernels.flash_attention`` takes
its plain version from ``models.attention``, and ``models.transformer``
calls the kernels, so importing the package must not pull in either side.
"""
