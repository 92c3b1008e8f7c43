"""dextractor_tpu_torch — the PyTorch/CUDA port of dextractor_tpu.

The port goes one slice at a time beside the JAX package, which stays the
reference it is held against byte for byte.  This slice is the ``.dexqv``
encode path:

- ``codecs.qv_codec.encode_quiva_to_dexqv``: the library entry point;
- ``parallel.pipeline.qv_encode_step``: the batched five-channel step;
- ``ops.emit``: wrappers of the hand-written CUDA kernels K1-K3
  (``ops/csrc/emit.cu``, built for sm_90a at first use), with their plain
  PyTorch twins in ``ops.bitstream_torch`` and ``parallel.pipeline``;
- ``cli``: ``python -m dextractor_tpu_torch dexqv``.

The package imports ``torch`` and never ``jax``.  It reuses the JAX-free
host modules of ``dextractor_tpu`` (``formats.quiva``, ``formats.ragged``,
``native``, ``utils``, ``cli._common``).
"""

__version__ = "0.1.0"
