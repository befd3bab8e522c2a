"""Useful FLOPs and kernel launches of one forward, one module per model
family, named by the configuration file's ``model_type``."""
