"""Runnable examples of the port, one module per example of the JAX
package's ``examples/``. Each runs with ``python -m
repro_torch.examples.<name>`` on the CUDA card, or with ``--device cpu``
on the CPU; importing one runs nothing."""
