from .camera import Camera, CameraParams
from .light import LightTable, build_light_table
from .material import Material, MaterialType
from .mesh import Mesh
from .scene import (FACE_ALIGN, GeometrySoA, MaterialTable, Scene,
                    build_scene, scene_from_numpy)
