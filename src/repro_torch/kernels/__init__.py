"""The port's kernels: CUDA C++ sources under ``csrc/``, one wrapper module
each with its plain version, the oracles (``ref``), dispatch (``ops``) and
the build (``build``)."""
