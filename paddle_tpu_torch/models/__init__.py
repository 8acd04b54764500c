"""Model code of the port: the GPT language model (its training program
and its serving math), ResNet, and the two recurrent configurations of
the reference's benchmark sweep, the stacked-LSTM text classifier and
the seq2seq attention NMT."""

from . import resnet  # noqa: F401
from . import seq2seq  # noqa: F401
from . import text_classification  # noqa: F401
from . import transformer  # noqa: F401
