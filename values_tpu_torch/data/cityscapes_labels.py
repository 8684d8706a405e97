"""Cityscapes label tables and the five synthetic ambiguity switch classes.

The port's copy of ``values_tpu/data/cityscapes_labels.py`` (reference:
uncertainty_modeling/data/cityscapes_labels.py:98-126): the standard
35-entry Cityscapes table, a GTA-only void colour, and five ``*_2``
switch classes (trainIds 19-23) that simulate rater ambiguity, so GTA
has 24 classes. ``color2trainId`` and ``trainId2color`` are built in
reversed order, the reference's tie-breaking.
"""
from __future__ import annotations

from collections import namedtuple

Label = namedtuple("Label", [
    "name", "id", "trainId", "category", "categoryId", "hasInstances",
    "ignoreInEval", "color"])

labels = [
    Label("unlabeled", 0, 255, "void", 0, False, True, (0, 0, 0)),
    Label("ego vehicle", 1, 255, "void", 0, False, True, (0, 0, 0)),
    Label("rectification border", 2, 255, "void", 0, False, True, (0, 0, 0)),
    Label("out of roi", 3, 255, "void", 0, False, True, (0, 0, 0)),
    Label("static", 4, 255, "void", 0, False, True, (0, 0, 0)),
    Label("dynamic", 5, 255, "void", 0, False, True, (111, 74, 0)),
    Label("ground", 6, 255, "void", 0, False, True, (81, 0, 81)),
    Label("road", 7, 0, "flat", 1, False, False, (128, 64, 128)),
    Label("sidewalk", 8, 1, "flat", 1, False, False, (244, 35, 232)),
    Label("parking", 9, 255, "flat", 1, False, True, (250, 170, 160)),
    Label("rail track", 10, 255, "flat", 1, False, True, (230, 150, 140)),
    Label("building", 11, 2, "construction", 2, False, False, (70, 70, 70)),
    Label("wall", 12, 3, "construction", 2, False, False, (102, 102, 156)),
    Label("fence", 13, 4, "construction", 2, False, False, (190, 153, 153)),
    Label("guard rail", 14, 255, "construction", 2, False, True,
          (180, 165, 180)),
    Label("bridge", 15, 255, "construction", 2, False, True,
          (150, 100, 100)),
    Label("tunnel", 16, 255, "construction", 2, False, True, (150, 120, 90)),
    Label("pole", 17, 5, "object", 3, False, False, (153, 153, 153)),
    Label("polegroup", 18, 255, "object", 3, False, True, (153, 153, 153)),
    Label("traffic light", 19, 6, "object", 3, False, False, (250, 170, 30)),
    Label("traffic sign", 20, 7, "object", 3, False, False, (220, 220, 0)),
    Label("vegetation", 21, 8, "nature", 4, False, False, (107, 142, 35)),
    Label("terrain", 22, 9, "nature", 4, False, False, (152, 251, 152)),
    Label("sky", 23, 10, "sky", 5, False, False, (70, 130, 180)),
    Label("person", 24, 11, "human", 6, True, False, (220, 20, 60)),
    Label("rider", 25, 12, "human", 6, True, False, (255, 0, 0)),
    Label("car", 26, 13, "vehicle", 7, True, False, (0, 0, 142)),
    Label("truck", 27, 14, "vehicle", 7, True, False, (0, 0, 70)),
    Label("bus", 28, 15, "vehicle", 7, True, False, (0, 60, 100)),
    Label("caravan", 29, 255, "vehicle", 7, True, True, (0, 0, 90)),
    Label("trailer", 30, 255, "vehicle", 7, True, True, (0, 0, 110)),
    Label("train", 31, 16, "vehicle", 7, True, False, (0, 80, 100)),
    Label("motorcycle", 32, 17, "vehicle", 7, True, False, (0, 0, 230)),
    Label("bicycle", 33, 18, "vehicle", 7, True, False, (119, 11, 32)),
    # license plate ignored (id -1 in the official table)
    Label("license plate", -1, 255, "vehicle", 7, False, True, (0, 0, 142)),
    # color that appears in the GTA renderings only
    Label("gta", -2, 255, "void", 0, False, True, (20, 20, 20)),
    # synthetic switch classes for simulated rater ambiguity
    Label("sidewalk_2", 34, 19, "flat", 1, False, False, (46, 247, 180)),
    Label("person_2", 35, 20, "human", 6, True, False, (167, 242, 242)),
    Label("car_2", 36, 21, "vehicle", 7, True, False, (30, 193, 252)),
    Label("vegetation_2", 37, 22, "nature", 4, False, False, (242, 160, 19)),
    Label("road_2", 38, 23, "flat", 1, False, False, (84, 86, 22)),
]

name2label = {label.name: label for label in labels}
id2label = {label.id: label for label in labels}
trainId2label = {label.trainId: label for label in reversed(labels)}
id2trainId = {label.id: label.trainId for label in labels}
# reversed so ambiguous colors resolve to the non-ignore entry
color2trainId = {label.color: label.trainId for label in reversed(labels)}
name2trainId = {label.name: label.trainId for label in labels}
# reversed so ignore trainIds all map to black
trainId2color = {label.trainId: label.color for label in reversed(labels)}

# the simulated-rater switch probabilities (augmentations.py:13-20,
# evaluation/utils/gta.py:20-27)
LABEL_SWITCHES = {
    "sidewalk": 1.0 / 3.0,
    "person": 1.0 / 3.0,
    "car": 1.0 / 3.0,
    "vegetation": 1.0 / 3.0,
    "road": 1.0 / 3.0,
}
