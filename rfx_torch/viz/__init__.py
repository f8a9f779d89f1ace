from .visualization import visualize, scene_to_html, serve_html

__all__ = ["visualize", "scene_to_html", "serve_html"]
