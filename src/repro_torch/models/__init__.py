"""Model zoo of the port: the dense transformer family."""
