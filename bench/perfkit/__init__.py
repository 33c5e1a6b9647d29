"""The benchmark's own code: manifest, weights, traffic, FLOP and byte
counts, the plain reference, the comparison, the trace reduction and the
run itself.  Nothing here imports the program at module level; the run
imports ``repro_torch`` (the PyTorch port) once the chip has been found."""
