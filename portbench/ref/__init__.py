"""The benchmark's yardstick: its inputs (``gen``) and the plain NumPy
reference (``encode``, ``huffman``) that decides ``correct``.  Nothing here
imports the program under test."""
