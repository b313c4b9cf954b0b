"""Visualisation helpers of the validation dumps (counterpart of
ingp_tpu/utils/vis.py): colour-mapped depth, mask and semantic images,
PNG writing through the port's own codec, and normals in the camera
frame.

The colormaps are OpenCV's COLORMAP_TURBO and COLORMAP_BONE as 256 x 3
uint8 tables in BGR order: `colormap(gray, TURBO)` equals
cv2.applyColorMap(gray, cv2.COLORMAP_TURBO) entry for entry, BGR order
included, which the callers flip with [..., ::-1] as the JAX trainer
does."""
from __future__ import annotations

import numpy as np

from ..data.image_io import write_png

_TURBO_HEX = (
    "3b12304315324a1833511b34581e355f21366624376d2738732a39792d3a802f3b86323c"
    "8b353d91383e973b3f9c3e3fa24040a74341ac4641b14942b54b42ba4e43bf5144c35444"
    "c75644cb5945cf5c45d35e45d66146da6446dd6646e06946e36b46e66e47e97147eb7347"
    "ee7647f07847f27b47f47d46f68046f88246fa8546fb8746fc8a45fd8c45fe8f44fe9143"
    "ff9442ff9641ff9940fe9b3efe9e3dfda03bfca33afba538faa837f8ab35f7ad33f5af31"
    "f4b22ff2b42ef0b72ceeb92aebbc28e9be27e7c025e4c323e2c522dfc720ddc91fdacb1e"
    "d8cd1cd5d01bd2d21ad0d41acdd519cad718c8d918c5db18c2dd18c0de18bde018bbe219"
    "b9e319b6e41ab4e61cb2e71dafe91facea20aaeb22a7ec25a4ee27a1ef2a9ef02c9bf12f"
    "98f23294f33591f4388ef53c8af63f87f74384f84680f84a7df94e7afa5276fa5573fb59"
    "6ffc5d6cfc6169fd6566fd6962fe6d5ffe715cfe7559fe7956ff7d53ff8051ff844eff88"
    "4bff8b49ff8f47ff9244fe9642fe9940fe9c3ffd9f3dfda13cfca43afca739fba938fbac"
    "37faaf36f9b136f8b435f7b735f6b934f5bc34f4be34f3c134f1c334f0c634efc834edcb"
    "34eccd34ead035e9d235e7d435e5d736e4d936e2db37e0dd37dfdf37dde138dbe338d9e5"
    "39d7e739d5e939d3eb3ad1ec3acfee3acdef3acbf13ac9f23ac7f43ac5f53ac3f63ac1f7"
    "39bef839bcf939bafa38b8fb37b6fb36b3fc36b1fc35aefd34acfd33a9fe32a7fe31a4fe"
    "30a1fe2f9efe2d9bfe2c99fe2b96fe2a93fe2990fe278dfd268afd2587fc2384fc2281fb"
    "217efb1f7bfa1e78f91d75f91c72f81a6ff7196cf61869f51766f41563f31460f2135df1"
    "125bf01158ef1055ed0f53ec0e50eb0d4eea0c4be80c49e70b47e50a45e40a43e20941e1"
    "083fdf083ddd073bdc0739da0637d80635d60533d40531d2052fd0042dce042bcc042aca"
    "0328c80326c50325c30223c10221be0220bc021eb9021db7011bb4011ab20118af0117ac"
    "0116a90114a70113a40112a101109e010f9b010e98010d95010b92010a8e02098b020888"
    "02078502068102057e03047a")

_BONE_HEX = (
    "0000000101010202020403030504040604040705050806060a07070b08080c09090d0a0a"
    "0e0a0a100b0b110c0c120d0d130e0e150f0f1610101711111812121912121b13131c1414"
    "1d15151e16161f1717211818221818231919241a1a251b1b271c1c281d1d291e1e2a1f1f"
    "2b20202d20202e21212f2222302323322424332525342626352626362727382828392929"
    "3a2a2a3b2b2b3c2c2c3e2d2d3f2e2e402e2e412f2f423030443131453232463333473434"
    "4834344a35354b36364c37374d38384f3939503a3a513b3b523c3c533c3c553d3d563e3e"
    "573f3f5840405941415b42425c42425d43435e44445f4545614646624747634848644949"
    "664949674a4a684b4b694c4c6a4d4d6c4e4e6d4f4f6e50506f5050705151715252735353"
    "745454755555765756765857775957785a58795b597a5d5a7b5e5b7c5f5c7d605d7e615e"
    "7e635e7f645f806560816661826762836963846a64846b65856c66866e66876f67887068"
    "8971698a726a8b746b8c756c8c766c8d776d8e786e8f7a6f907b70917c71927d72927e73"
    "9380749481749582759683769784779886789987799a887a9a897a9b8a7b9c8c7c9d8d7d"
    "9e8e7e9f8f7fa09180a09281a19382a29482a39583a49784a59885a69986a79a87a89b88"
    "a89d88a99e89aa9f8aaba08baca18cada38daea48eaea58fafa690b0a890b1a991b2aa92"
    "b3ab93b4ac94b5ae95b6af96b6b096b7b197b8b298b9b499bab59abbb69bbcb79cbcb89d"
    "bdba9ebebb9ebfbc9fc0bda0c1bea1c2c0a2c3c1a3c4c2a4c4c3a4c5c4a5c6c6a6c7c7a7"
    "c8c8a9c9c9aacacaabcbcbaccbcbaeccccafcdcdb1ceceb2cfcfb3d0d0b5d1d1b6d2d2b8"
    "d2d2b9d3d3bad4d4bcd5d5bdd6d6bed7d7c0d8d8c1d8d8c3d9d9c4dadac5dbdbc7dcdcc8"
    "ddddc9dedecbdfdfcce0e0cee0e0cfe1e1d0e2e2d2e3e3d3e4e4d4e5e5d6e6e6d7e7e7d8"
    "e7e7dae8e8dbe9e9ddeaeadeebebdfecece1edede2eeeee4eeeee5efefe6f0f0e8f1f1e9"
    "f2f2eaf3f3ecf4f4edf4f4eff5f5f0f6f6f1f7f7f3f8f8f4f9f9f5fafaf7fbfbf8fcfcfa"
    "fcfcfbfdfdfcfefefeffffff")

TURBO = np.frombuffer(bytes.fromhex("".join(_TURBO_HEX)), np.uint8
                      ).reshape(256, 3)
BONE = np.frombuffer(bytes.fromhex("".join(_BONE_HEX)), np.uint8
                     ).reshape(256, 3)


def colormap(gray, table):
    """cv2.applyColorMap of a uint8 (H, W) image: (H, W, 3) BGR."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8:
        raise ValueError(f"colormap takes uint8, not {gray.dtype}")
    return table[gray]


def depth2img(depth, scale=16):
    """Depth map -> TURBO colormap image (BGR), depth / scale in [0, 1]."""
    depth = np.clip(np.asarray(depth) / scale, 0.0, 1.0)
    return colormap((depth * 255).astype(np.uint8), TURBO)


def mask2img(mask):
    """Mask in [0, 1] -> BONE colormap image (BGR)."""
    return colormap((np.asarray(mask) * 255).astype(np.uint8), BONE)


def semantic2img(sem_label, classes):
    """Class labels -> TURBO colormap image (BGR), classes spread over
    the map."""
    level = 1.0 / (classes - 1)
    sem_color = level * np.asarray(sem_label)
    return colormap((sem_color * 255).astype(np.uint8), TURBO)


def save_image(image, path):
    """An image in [0, 1] (clipped), (H, W), (H, W, 3) or (H, W, 4), as
    an 8-bit PNG."""
    image = np.clip(np.asarray(image), 0.0, 1.0)
    write_png(path, (image * 255).astype(np.uint8))


def convert_normal(normal, pose_c2w):
    """World -> camera-frame normals."""
    R_w2c = np.asarray(pose_c2w)[:3, :3].T
    return np.asarray(normal) @ R_w2c.T
