"""Deterministic data for the port (numpy; its own copies): synthetic
tokens and images, and the npz image pipeline."""
from .imagenet import NpzImageTask, resolve_image_task, write_demo_dataset
from .synthetic import ImageTask, TokenTask

__all__ = ["ImageTask", "NpzImageTask", "TokenTask", "resolve_image_task",
           "write_demo_dataset"]
