"""Ray-march kernels for the GPU (see ``march``)."""
