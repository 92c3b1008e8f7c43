"""dextractor_tpu_torch — the PyTorch/CUDA port of dextractor_tpu.

The port goes one slice at a time beside the JAX package, which stays the
reference it is held against byte for byte.  The slices so far are the
``.dexqv`` encode and decode paths, the 2-bit codecs, and the ingest layer
with ``dextract`` and the Dazzler DB family:

- ``codecs.qv_codec.encode_quiva_to_dexqv`` / ``decode_dexqv_to_quiva`` and
  ``codecs.twobit_codec`` (``.fasta`` <-> ``.dexta``, ``.arrow`` <->
  ``.dexar``): the library entry points;
- ``parallel.pipeline.qv_encode_step`` and ``ops.decode2.decode_entry_batch2``:
  the batched five-channel encode and decode steps;
- ``ops.emit`` (K1-K3), ``ops.decode_chains`` (K4, K5), ``ops.expand``
  (K6) and ``ops.pack2bit`` (K7 and the 2-bit unpack): wrappers of the
  hand-written CUDA kernels in ``ops/csrc/`` (built for sm_90a at first
  use), with their plain PyTorch twins in ``ops.bitstream_torch``,
  ``parallel.pipeline``, ``ops.decode2`` and ``ops.twobit``;
- ``ingest`` (the -e filter, the BAM/SAM and .bax.h5 readers) and ``db``
  (the Dazzler DB library and its builder, on the host;
  ``db.DazzDB.load_all_qventries`` decodes the QV streams with K4-K6);
- ``cli``: ``python -m dextractor_tpu_torch`` dexqv, undexqv, dexta,
  undexta, dexar, undexar, dextract and dex2DB.

The package imports ``torch`` and never ``jax``, and nothing of
``dextractor_tpu``: it keeps its own copies of the host modules it needs
(``formats.quiva``, ``formats.ragged``, ``formats.fasta``,
``formats.dexta``, ``native`` and its C sources, ``utils``, ``cli._common``,
``ingest``, ``db``).
"""

__version__ = "0.1.0"
