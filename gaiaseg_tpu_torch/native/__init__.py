"""Native (C++) host code of the port, built on demand with g++."""
from .build import load_packio  # noqa: F401
