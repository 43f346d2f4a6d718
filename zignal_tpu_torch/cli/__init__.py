"""CLI package: the 12 subcommands of zignal_tpu/cli/ on the port, run on
``--device`` (``cuda`` unless ``--device cpu``) (reference: src/cli/)."""
