"""Human3.6M dataset (a copy of ``gastx.data.h36m``): the published
camera calibration in flat numpy tables and the serialized-3D loader,
with the keypoint-type-dependent joint removal (sh -> 16 joints, cpn/gt
-> 17, cpn_..._19 -> 19 with toes) and its shoulder reparenting.
"""
from __future__ import annotations

import numpy as np

from gastx_torch.data.mocap import MocapDataset
from gastx_torch.geometry import normalize_screen_coordinates
from gastx_torch.skeleton import Skeleton

TRAIN_SUBJECTS = ["S1", "S5", "S6", "S7", "S8"]
TEST_SUBJECTS = ["S9", "S11"]

# 32-joint source skeleton (common/h36m_dataset.py:8-11).
H36M_32_SKELETON = dict(
    parents=[-1, 0, 1, 2, 3, 4, 0, 6, 7, 8, 9, 0, 11, 12, 13, 14, 12,
             16, 17, 18, 19, 20, 19, 22, 12, 24, 25, 26, 27, 28, 27, 30],
    joints_left=[6, 7, 8, 9, 10, 16, 17, 18, 19, 20, 21, 22, 23],
    joints_right=[1, 2, 3, 4, 5, 24, 25, 26, 27, 28, 29, 30, 31],
)

# Named joints among the 32 (common/h36m_dataset.py:16-33); '' = unnamed.
H36M_NAMES = [""] * 32
for _i, _n in [(0, "Hip"), (1, "RHip"), (2, "RKnee"), (3, "RAnkle"),
               (6, "LHip"), (7, "LKnee"), (8, "LAnkle"), (12, "Spine"),
               (13, "Thorax"), (14, "Neck/Nose"), (15, "Head"),
               (17, "LShoulder"), (18, "LElbow"), (19, "LWrist"),
               (25, "RShoulder"), (26, "RElbow"), (27, "RWrist")]:
    H36M_NAMES[_i] = _n

# --- camera intrinsics: 4 cameras, columns = cx cy fx fy k1 k2 k3 p1 p2 ---
CAMERA_IDS = ("54138969", "55011271", "58860488", "60457274")
CAMERA_RES = ((1000, 1002), (1000, 1000), (1000, 1000), (1000, 1002))
CAMERA_AZIMUTH = (70, -70, 110, -110)  # visualization only

_INTRINSICS = np.array([
    # cx, cy, fx, fy, k1, k2, k3, p1, p2
    [512.54150390625, 515.4514770507812, 1145.0494384765625,
     1143.7811279296875, -0.20709891617298126, 0.24777518212795258,
     -0.0030751503072679043, -0.0009756988729350269, -0.00142447161488235],
    [508.8486328125, 508.0649108886719, 1149.6756591796875,
     1147.5916748046875, -0.1942136287689209, 0.2404085397720337,
     0.006819975562393665, -0.0016190266469493508, -0.0027408944442868233],
    [519.8158569335938, 501.40264892578125, 1149.1407470703125,
     1148.7989501953125, -0.2083381861448288, 0.25548800826072693,
     -0.0024604974314570427, 0.0014843869721516967, -0.0007599993259645998],
    [514.9682006835938, 501.88201904296875, 1145.5113525390625,
     1144.77392578125, -0.198384091258049, 0.21832367777824402,
     -0.008947807364165783, -0.0005872055771760643, -0.0018133620033040643],
], dtype=np.float32)

# --- camera extrinsics per subject: orientation quaternion wxyz + translation
# (mm). Rows: 4 cameras in CAMERA_IDS order. ---
_EXTRINSICS = {
    "S1": np.array([
        [0.1407056450843811, -0.1500701755285263, -0.755240797996521,
         0.6223280429840088, 1841.1070556640625, 4955.28466796875,
         1563.4454345703125],
        [0.6157187819480896, -0.764836311340332, -0.14833825826644897,
         0.11794740706682205, 1761.278564453125, -5078.0068359375,
         1606.2650146484375],
        [0.14651472866535187, -0.14647851884365082, 0.7653023600578308,
         -0.6094175577163696, -1846.7777099609375, 5215.04638671875,
         1491.972412109375],
        [0.5834008455276489, -0.7853162288665771, 0.14548823237419128,
         -0.14749594032764435, -1794.7896728515625, -3722.698974609375,
         1574.8927001953125],
    ], dtype=np.float32),
    "S5": np.array([
        [0.1467377245426178, -0.162370964884758, -0.7551892995834351,
         0.6178938746452332, 2097.3916015625, 4880.94482421875,
         1605.732421875],
        [0.6159758567810059, -0.7626792192459106, -0.15728192031383514,
         0.1189815029501915, 2031.7008056640625, -5167.93310546875,
         1612.923095703125],
        [0.14291371405124664, -0.12907841801643372, 0.7678384780883789,
         -0.6110143065452576, -1620.5948486328125, 5171.65869140625,
         1496.43701171875],
        [0.5920479893684387, -0.7814217805862427, 0.1274748593568802,
         -0.15036417543888092, -1637.1737060546875, -3867.3173828125,
         1547.033203125],
    ], dtype=np.float32),
    "S6": np.array([
        [0.1337897777557373, -0.15692396461963654, -0.7571090459823608,
         0.6198879480361938, 1935.4517822265625, 4950.24560546875,
         1618.0838623046875],
        [0.6147197484970093, -0.7628812789916992, -0.16174767911434174,
         0.11819244921207428, 1969.803955078125, -5128.73876953125,
         1632.77880859375],
        [0.1529948115348816, -0.13529130816459656, 0.7646096348762512,
         -0.6112781167030334, -1769.596435546875, 5185.361328125,
         1476.993408203125],
        [0.5916101336479187, -0.7804774045944214, 0.12832270562648773,
         -0.1561593860387802, -1721.668701171875, -3884.13134765625,
         1540.4879150390625],
    ], dtype=np.float32),
    "S7": np.array([
        [0.1435241848230362, -0.1631336808204651, -0.7548328638076782,
         0.6188824772834778, 1974.512939453125, 4926.3544921875,
         1597.8326416015625],
        [0.6141672730445862, -0.7638262510299683, -0.1596645563840866,
         0.1177929937839508, 1937.0584716796875, -5119.7900390625,
         1631.5665283203125],
        [0.14550060033798218, -0.12874816358089447, 0.7660516500473022,
         -0.6127139329910278, -1741.8111572265625, 5208.24951171875,
         1464.8245849609375],
        [0.5912848114967346, -0.7821764349937439, 0.12445473670959473,
         -0.15196487307548523, -1734.7105712890625, -3832.42138671875,
         1548.5830078125],
    ], dtype=np.float32),
    "S8": np.array([
        [0.14110587537288666, -0.15589867532253265, -0.7561917304992676,
         0.619644045829773, 2150.65185546875, 4896.1611328125,
         1611.9046630859375],
        [0.6169601678848267, -0.7647668123245239, -0.14846350252628326,
         0.11158157885074615, 2219.965576171875, -5148.453125,
         1613.0440673828125],
        [0.1471444070339203, -0.13377119600772858, 0.7670128345489502,
         -0.6100369691848755, -1571.2215576171875, 5137.0185546875,
         1498.1761474609375],
        [0.5927824378013611, -0.7825870513916016, 0.12147816270589828,
         -0.14631995558738708, -1476.913330078125, -3896.7412109375,
         1547.97216796875],
    ], dtype=np.float32),
    "S9": np.array([
        [0.15540587902069092, -0.15548215806484222, -0.7532095313072205,
         0.6199594736099243, 2044.45849609375, 4935.1171875,
         1481.2275390625],
        [0.618784487247467, -0.7634735107421875, -0.14132238924503326,
         0.11933968216180801, 1990.959716796875, -5123.810546875,
         1568.8048095703125],
        [0.13357827067375183, -0.1367100477218628, 0.7689454555511475,
         -0.6100738644599915, -1670.9921875, 5211.98583984375,
         1528.387939453125],
        [0.5879399180412292, -0.7823407053947449, 0.1427614390850067,
         -0.14794869720935822, -1696.04345703125, -3827.099853515625,
         1591.4127197265625],
    ], dtype=np.float32),
    "S11": np.array([
        [0.15232472121715546, -0.15442320704460144, -0.7547563314437866,
         0.6191070079803467, 2098.440185546875, 4926.5546875,
         1500.278564453125],
        [0.6189449429512024, -0.7600917220115662, -0.15300633013248444,
         0.1255258321762085, 2083.182373046875, -4912.1728515625,
         1561.07861328125],
        [0.14943228662014008, -0.15650227665901184, 0.7681233882904053,
         -0.6026304364204407, -1609.8153076171875, 5177.3359375,
         1537.896728515625],
        [0.5894251465797424, -0.7818877100944519, 0.13991211354732513,
         -0.14715361595153809, -1590.738037109375, -3854.1689453125,
         1578.017578125],
    ], dtype=np.float32),
}


def h36m_cameras() -> dict:
    """Per-subject camera dicts with screen-normalized intrinsics.

    Each camera carries: id, res_w/res_h, azimuth, center/focal_length
    (normalized to unit screen coords as in common/h36m_dataset.py:243-245),
    radial/tangential distortion, orientation (wxyz), translation (meters),
    and the 9-dim ``intrinsic`` vector [f, c, k, p] consumed by
    ``project_to_2d``.
    """
    cameras = {}
    for subject, ext in _EXTRINSICS.items():
        cams = []
        for i in range(4):
            w, h = CAMERA_RES[i]
            center = np.asarray(normalize_screen_coordinates(
                _INTRINSICS[i, :2], w=w, h=h), dtype=np.float32)
            focal = (_INTRINSICS[i, 2:4] / w * 2).astype(np.float32)
            cam = {
                "id": CAMERA_IDS[i],
                "res_w": w,
                "res_h": h,
                "azimuth": CAMERA_AZIMUTH[i],
                "center": center,
                "focal_length": focal,
                "radial_distortion": _INTRINSICS[i, 4:7].copy(),
                "tangential_distortion": _INTRINSICS[i, 7:9].copy(),
                "orientation": ext[i, :4].copy(),
                "translation": (ext[i, 4:] / 1000.0).astype(np.float32),
            }
            cam["intrinsic"] = np.concatenate([
                cam["focal_length"], cam["center"],
                cam["radial_distortion"], cam["tangential_distortion"]])
            cams.append(cam)
        cameras[subject] = cams
    return cameras


class Human36mDataset(MocapDataset):
    """Loads ``data_3d_h36m.npz`` (positions_3d dict) at 50 fps.

    ``keypoints_type`` selects the joint reduction
    (common/h36m_dataset.py:266-293):
      * ``sh_ft_h36m`` / ``sh_pt_mpii`` -> 16 joints (drop unnamed + nose)
      * ``cpn_ft_h36m_dbb`` / ``gt``    -> 17 joints
      * ``cpn_ft_h36m_dbb_19``          -> 19 joints incl. toes
    """

    def __init__(self, path: str, keypoints_type: str = "cpn_ft_h36m_dbb",
                 remove_static_joints: bool = True):
        super().__init__(fps=50, skeleton=Skeleton(**H36M_32_SKELETON))
        self._cameras = h36m_cameras()

        data = np.load(path, allow_pickle=True)["positions_3d"].item()
        self._data = {}
        for subject, actions in data.items():
            self._data[subject] = {}
            for action_name, positions in actions.items():
                self._data[subject][action_name] = {
                    "positions": positions,
                    "cameras": self._cameras[subject],
                }

        if not remove_static_joints:
            return

        if keypoints_type in ("sh_ft_h36m", "sh_pt_mpii"):
            self.remove_joints([i for i, x in enumerate(H36M_NAMES)
                                if x == "" or x == "Neck/Nose"])
            self._skeleton._parents[10] = 8
            self._skeleton._parents[13] = 8
        elif keypoints_type in ("cpn_ft_h36m_dbb", "gt"):
            self.remove_joints([4, 5, 9, 10, 11, 16, 20, 21, 22, 23, 24,
                                28, 29, 30, 31])
            self._skeleton._parents[11] = 8
            self._skeleton._parents[14] = 8
        elif keypoints_type == "cpn_ft_h36m_dbb_19":
            self.remove_joints([5, 10, 11, 16, 20, 21, 22, 23, 24, 28, 29,
                                30, 31])
            self._skeleton._parents[13] = 10
            self._skeleton._parents[16] = 10
        else:
            raise ValueError(f"unknown keypoints_type {keypoints_type!r}")
        self._skeleton._compute_metadata()
