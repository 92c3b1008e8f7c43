"""The harness of the benchmark of dextractor_tpu_torch: the registry of
cells by name, the card's set-up, the traffic kinds, the window, the trace
and its readings."""
