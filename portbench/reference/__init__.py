"""The benchmark's plain reference: straightforward PyTorch versions of
what the port computes, held here so that a change to the program cannot
move them.  Nothing in this package imports the program or JAX, and it
takes nothing the program made: it works the codebook, the codes and the
index layout out again from the benchmark's own inputs."""
