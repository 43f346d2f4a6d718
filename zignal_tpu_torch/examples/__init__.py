"""The examples of examples/ on the port, one module each, run as

    python -m zignal_tpu_torch.examples.<name> [IMAGE] [--device cpu]
        [--out DIR]

on the card unless ``--device cpu``; without IMAGE a seeded synthetic
image is the input, and the outputs go to ``--out`` (default
``examples_out`` in the working directory). ``multichip_pipeline`` and
``image_batch`` run their mesh on the ranks of ``torchrun`` (``torchrun
--nproc-per-node N -m zignal_tpu_torch.examples.multichip_pipeline``), or
as a group of this process alone.
"""
