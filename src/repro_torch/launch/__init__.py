"""Launch: the serving CLI of the port."""
