"""Instrument-file ingest: the -e filter DSL, the BAM/SAM and .bax.h5 readers
and the .fasta/.arrow/.quiva entry writers (``dextractor_tpu/ingest/``)."""

from .filter import parse_filter, Filter, FilterError
