"""See the module of the same name in multinn_tpu."""
