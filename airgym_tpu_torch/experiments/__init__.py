"""Kernels off the default path (counterpart of airgym_tpu/experiments/).

``fused_cnn``: the whole CNN encoder stack in one forward and one
backward kernel, selected with ``CNNEncoder(impl='pallas')`` (or
``network_kw={"cnn_impl": "pallas"}`` for the trainer).
"""
