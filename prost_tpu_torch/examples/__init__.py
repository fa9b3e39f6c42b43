"""The example scripts (counterpart of the JAX package's ``examples/``).

Each ``example_*`` module has ``run(...)``, which builds its model with the
modeling API, solves it on ``config.device()`` and returns a dict with the
same keys as the JAX example's plus ``route`` (the backend class and the
fused route it took), and ``main()`` for the command line:

    python -m prost_tpu_torch.examples.example_rof_primaldual --size 128
    python -m prost_tpu_torch.examples.example_rof_primaldual --cpu

The scripts run on the first CUDA card; ``--cpu`` (``set_device("cpu")``)
runs them on the CPU, where the fused routes use their kernels' plain
PyTorch versions.
"""
