from .logging import clear_level, get_logger, set_level

__all__ = ["clear_level", "get_logger", "set_level"]
