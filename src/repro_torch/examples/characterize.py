"""The probe suite (counterpart of ``examples/characterize.py``): the
paper's microbenchmarks on this device, printed as its tables -- §IV
latency, §V matmul / precision, §VI memory hierarchy.
``repro_torch.launch.characterize`` runs them at this example's sizes;
this module only calls it.

    PYTHONPATH=src python -m repro_torch.examples.characterize   # the card
    PYTHONPATH=src python -m repro_torch.examples.characterize --device cpu
"""

from repro_torch.launch.characterize import main

if __name__ == "__main__":
    raise SystemExit(main())
