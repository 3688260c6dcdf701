"""Small command-line tools of the port."""
