from volumetric_renderer.data.volume import Volume
from volumetric_renderer.data.importer import import_volume

__all__ = ["Volume", "import_volume"]
