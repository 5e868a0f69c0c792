version = "0.1.0"
__version__ = version
