"""Architecture configurations (``ArchConfig``) and their registry."""
