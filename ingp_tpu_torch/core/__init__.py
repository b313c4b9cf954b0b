from .rays import get_ray_directions, get_rays
from .intersect import ray_aabb_intersect
from .morton import morton3d, morton3d_invert
