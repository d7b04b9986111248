"""The plain reference: NumPy only, nothing of the program.  One module
per family of cones, named by a configuration's "reference" key, has
`measures` (the certificate of returned answers) and `solve` (one
problem solved again; in float32 it is the benchmark's control)."""
