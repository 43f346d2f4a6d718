"""`zignal-torch version` (reference: src/cli/version.zig), copied from
zignal_tpu/cli/version_cmd.py."""

description = "Print the zignal version."


def configure(parser):
    pass


def run(args):
    from .. import __version__

    print(f"zignal {__version__} (zignal_tpu_torch)")
    return 0
