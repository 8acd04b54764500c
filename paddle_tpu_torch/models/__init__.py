"""Model code of the port (the GPT language model: its training program
and its serving math)."""

from . import transformer  # noqa: F401
