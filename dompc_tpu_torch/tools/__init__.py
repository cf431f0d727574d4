"""Structure / utility tools (numpy-only copies of the JAX package's
``tools``: :class:`StructSpec`, :class:`NumStruct`, :class:`FieldAccessor`,
:class:`Timer`, the pickle helpers and the progress bar) plus
``profiler``, the torch profiler's annotations and trace capture."""
import pickle

from ._structure import StructSpec, NumStruct, FieldAccessor, Structure
from ._timer import Timer
from . import _profiler as profiler


def save_pickle(filename, data):
    """Save arbitrary data to a pickle file (reference: tools/__init__.py:31)."""
    if not filename.endswith(".pkl"):
        filename += ".pkl"
    with open(filename, "wb") as f:
        pickle.dump(data, f)


def load_pickle(filename):
    """Load data from a pickle file (reference: tools/__init__.py:41)."""
    if not filename.endswith(".pkl"):
        filename += ".pkl"
    with open(filename, "rb") as f:
        return pickle.load(f)


def printProgressBar(iteration, total, prefix="", suffix="", decimals=1,
                     length=100, fill="█", printEnd="\r"):
    """Terminal progress bar (reference: tools/__init__.py:46-61)."""
    percent = ("{0:." + str(decimals) + "f}").format(
        100 * (iteration / float(total)))
    filled = int(length * iteration // total)
    bar = fill * filled + "-" * (length - filled)
    print(f"\r{prefix} |{bar}| {percent}% {suffix}", end=printEnd)
    if iteration == total:
        print()


__all__ = ["StructSpec", "NumStruct", "FieldAccessor", "Structure", "Timer",
           "profiler", "save_pickle", "load_pickle", "printProgressBar"]
