from .network_gui import NetworkGUI, make_map_render_fn
from .rerun_logger import RerunLogger

__all__ = ["NetworkGUI", "RerunLogger", "make_map_render_fn"]
