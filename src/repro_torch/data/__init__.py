from .pipeline import DataConfig, InstructionStream, make_stream  # noqa: F401
