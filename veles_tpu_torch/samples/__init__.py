"""Model configurations and parameter layouts of the port."""
