from . import cnn  # noqa: F401
