"""Models of the port: the flagship PatchRefinerPlus and its blocks."""
