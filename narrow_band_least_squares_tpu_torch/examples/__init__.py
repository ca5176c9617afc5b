"""Example drivers of the port, run as modules on synthetic data (offline):

    python -m narrow_band_least_squares_tpu_torch.examples.example
    python -m narrow_band_least_squares_tpu_torch.examples.example_monitoring
    python -m narrow_band_least_squares_tpu_torch.examples.example_streaming_ingest
    python -m narrow_band_least_squares_tpu_torch.examples.example_parallel

Each runs on the card unless given ``--cpu``, and writes under
``build/torch_examples/`` at the repository root (``example_parallel``
writes nothing; under ``torchrun`` it runs one rank per process).
"""

import os

OUT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_examples",
)


def device_from_argv(argv=None) -> str:
    """``"cpu"`` when the command line says ``--cpu``, else ``"cuda"``."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain PyTorch versions on the CPU")
    return "cpu" if ap.parse_args(argv).cpu else "cuda"
