"""Model code of the port: the GPT language model (its training program
and its serving math) and ResNet."""

from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
