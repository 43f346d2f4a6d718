"""Vision features: FAST, ORB, binary descriptors, matching, tracing
(reference: src/features/), the counterpart of zignal_tpu/features/.

FAST, ORB's device path and the Hamming distances run on torch on their
input's device; the descriptor, the BRIEF pattern and the tracer are host
copies of the JAX package's modules."""

from .descriptor import BinaryDescriptor
from .fast import Fast, KeyPoint
from .matcher import BruteForceMatcher, Match
from .orb import Orb
from .tracer import Tracer

__all__ = ["KeyPoint", "Fast", "Orb", "BinaryDescriptor",
           "BruteForceMatcher", "Match", "Tracer"]
