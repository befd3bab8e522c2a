"""Plain float32 references, one module per model family, named by the
configuration file's ``model_type``. They import nothing of the program."""
import importlib


def family(model_type: str):
    """The reference module of ``model_type``."""
    return importlib.import_module(f"coebench.reference.{model_type}")
