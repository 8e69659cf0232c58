"""Train-step builder and the training CLI of the port."""
