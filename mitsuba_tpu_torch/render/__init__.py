"""Scene, shapes, plugins and records."""
