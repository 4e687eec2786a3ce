from .base import ArchConfig

__all__ = ["ArchConfig"]
