"""Object detection: the YOLOv2 output layer and the per-pixel CNN loss layer.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/objdetect.py``, the same
layouts (NHWC):

- the activations into ``Yolo2OutputLayer``: (b, H, W, B*(5+C)), per box
  [tx, ty, tw, th, tconf, class logits...];
- its labels: (b, H, W, 4+C), [x1, y1, x2, y2] in grid units and a one-hot
  class at the cell that holds the box's center, zeros elsewhere.

The loss is elementwise work and small reductions over the dense
(b, H, W, B) lattice, in the reference's operations: the IOU target of the
confidence term is held constant (``.detach()``, the reference's
``stop_gradient``), the responsible box is the first of the highest IOU
(``argmax``'s tie rule in both), and a ``jnp.maximum`` against a constant
is ``torch.maximum`` against a filled tensor (half the gradient at a tie).
Decoding boxes and non-max suppression run on the host, over the dense
output.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer

_floor = _losses._floor


@serde.register
class CnnLossLayer(Layer):
    """A loss head without params over CNN activations: input (b, H, W, C),
    labels of the same shape, the loss at every position summed per
    example; a mask is (b, H, W)."""

    is_output_layer = True

    def __init__(self, loss: str = "mcxent", activation: str = "identity", **kwargs):
        super().__init__(**kwargs)
        self.loss = loss
        self.activation = activation

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return _act.get(self.activation)(x), state or {}

    def compute_score(self, params, x, labels, mask=None) -> torch.Tensor:
        b = x.shape[0]
        xf = x.reshape(-1, x.shape[-1])
        lf = labels.reshape(-1, labels.shape[-1])
        mf = None if mask is None else mask.reshape(-1)[:, None]
        per_pos = _losses.get(self.loss)(lf, xf, self.activation, mf)
        return per_pos.reshape(b, -1).sum(dim=1)


class DetectedObject:
    """One predicted box; coordinates in grid units."""

    def __init__(self, example: int, center_x: float, center_y: float,
                 width: float, height: float, predicted_class: int,
                 confidence: float, class_probs: Optional[np.ndarray] = None):
        self.example = example
        self.center_x = center_x
        self.center_y = center_y
        self.width = width
        self.height = height
        self.predicted_class = predicted_class
        self.confidence = confidence
        self.class_probs = class_probs

    def top_left(self) -> Tuple[float, float]:
        return (self.center_x - self.width / 2, self.center_y - self.height / 2)

    def bottom_right(self) -> Tuple[float, float]:
        return (self.center_x + self.width / 2, self.center_y + self.height / 2)

    def __repr__(self):
        return (f"DetectedObject(ex={self.example}, c=({self.center_x:.2f},"
                f"{self.center_y:.2f}), wh=({self.width:.2f},{self.height:.2f}), "
                f"cls={self.predicted_class}, conf={self.confidence:.3f})")


def iou(a: DetectedObject, b: DetectedObject) -> float:
    """Intersection over union of two boxes."""
    ax1, ay1 = a.top_left()
    ax2, ay2 = a.bottom_right()
    bx1, by1 = b.top_left()
    bx2, by2 = b.bottom_right()
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / union if union > 0 else 0.0


def non_max_suppression(objs: List[DetectedObject], iou_threshold: float = 0.45
                        ) -> List[DetectedObject]:
    """Greedy NMS per (example, class): the most confident box first, a box
    kept when its IOU with every kept one is below ``iou_threshold``."""
    out: List[DetectedObject] = []
    by_cls: dict = {}
    for o in objs:
        by_cls.setdefault((o.example, o.predicted_class), []).append(o)
    for group in by_cls.values():
        kept: List[DetectedObject] = []
        for o in sorted(group, key=lambda o: -o.confidence):
            if all(iou(o, k) < iou_threshold for k in kept):
                kept.append(o)
        out.extend(kept)
    return out


@serde.register
class Yolo2OutputLayer(Layer):
    """YOLOv2's output layer. ``bounding_box_priors``: (B, 2) anchor
    (width, height) priors in grid units."""

    is_output_layer = True

    def __init__(self, bounding_box_priors=None, lambda_coord: float = 5.0,
                 lambda_no_obj: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        if bounding_box_priors is None:
            raise ValueError("Yolo2OutputLayer requires boundingBoxPriors (B,2)")
        # the reference's f32 values, so the configuration dicts match
        self.bounding_box_priors = np.asarray(bounding_box_priors, np.float32).tolist()
        self.lambda_coord = float(lambda_coord)
        self.lambda_no_obj = float(lambda_no_obj)

    @property
    def n_boxes(self) -> int:
        return len(self.bounding_box_priors)

    def get_output_type(self, input_type):
        return input_type

    def _priors_on(self, device) -> torch.Tensor:
        """The priors as an f32 (B, 2) tensor on ``device``, made once a
        device: a copy from the host cannot run inside a captured CUDA
        graph (a bundled train step), a cached tensor can."""
        cache = self.__dict__.setdefault("_priors", {})
        if device not in cache:
            cache[device] = torch.tensor(self.bounding_box_priors, dtype=torch.float32,
                                         device=device)
        return cache[device]

    def _split_predictions(self, x: torch.Tensor):
        """(b,H,W,B*(5+C)) -> sigmoid xy (b,H,W,B,2), wh (b,H,W,B,2) in grid
        units, conf (b,H,W,B), class logits (b,H,W,B,C), C."""
        b, h, w, d = x.shape
        per = d // self.n_boxes
        x5 = x.reshape(b, h, w, self.n_boxes, per)
        xy = torch.sigmoid(x5[..., 0:2])
        wh = torch.exp(x5[..., 2:4]) * self._priors_on(x.device)
        conf = torch.sigmoid(x5[..., 4])
        return xy, wh, conf, x5[..., 5:], per - 5

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        """The activated predictions in the packed layout (what
        :meth:`get_predicted_objects` decodes)."""
        xy, wh, conf, cls_logits, _ = self._split_predictions(x)
        cls_p = torch.softmax(cls_logits, dim=-1)
        out = torch.cat([xy, wh, conf[..., None], cls_p], dim=-1)
        return out.reshape(x.shape), state or {}

    def compute_score(self, params, x, labels, mask=None) -> torch.Tensor:
        """The YOLOv2 loss per example: position and sqrt-size SSE of the
        responsible box, confidence toward its IOU (0 elsewhere, weighted by
        ``lambda_no_obj``), class cross-entropy at object cells."""
        b, h, w, _ = x.shape
        xy, wh, conf, cls_logits, _ = self._split_predictions(x)
        gt_box, gt_cls = labels[..., :4], labels[..., 4:]
        has_obj = (gt_cls.sum(dim=-1) > 0).to(x.dtype)  # (b,H,W)

        gt_cx = (gt_box[..., 0] + gt_box[..., 2]) / 2
        gt_cy = (gt_box[..., 1] + gt_box[..., 3]) / 2
        gt_w = _floor(gt_box[..., 2] - gt_box[..., 0], 1e-6)
        gt_h = _floor(gt_box[..., 3] - gt_box[..., 1], 1e-6)

        cols = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, :]
        rows = torch.arange(h, dtype=x.dtype, device=x.device)[None, :, None]
        gt_ox, gt_oy = gt_cx - cols, gt_cy - rows

        pred_cx = xy[..., 0] + cols[..., None]
        pred_cy = xy[..., 1] + rows[..., None]
        pred_w, pred_h = wh[..., 0], wh[..., 1]

        # IOU of each predicted box with its cell's ground truth (b,H,W,B)
        px1, px2 = pred_cx - pred_w / 2, pred_cx + pred_w / 2
        py1, py2 = pred_cy - pred_h / 2, pred_cy + pred_h / 2
        gx1, gx2 = gt_cx[..., None] - gt_w[..., None] / 2, gt_cx[..., None] + gt_w[..., None] / 2
        gy1, gy2 = gt_cy[..., None] - gt_h[..., None] / 2, gt_cy[..., None] + gt_h[..., None] / 2
        zeros = torch.zeros((), dtype=x.dtype, device=x.device)
        iw = torch.maximum(zeros, torch.minimum(px2, gx2) - torch.maximum(px1, gx1))
        ih = torch.maximum(zeros, torch.minimum(py2, gy2) - torch.maximum(py1, gy1))
        inter = iw * ih
        union = pred_w * pred_h + (gt_w * gt_h)[..., None] - inter
        ious = inter / _floor(union, 1e-6)

        # the responsible box: the first of the highest IOU in an object cell
        best = torch.argmax(ious, dim=-1, keepdim=True)
        boxes = torch.arange(self.n_boxes, device=x.device)
        resp = (best == boxes).to(x.dtype) * has_obj[..., None]

        pos = (xy[..., 0] - gt_ox[..., None]) ** 2 + (xy[..., 1] - gt_oy[..., None]) ** 2
        size = ((torch.sqrt(_floor(pred_w, 1e-6)) - torch.sqrt(gt_w)[..., None]) ** 2
                + (torch.sqrt(_floor(pred_h, 1e-6)) - torch.sqrt(gt_h)[..., None]) ** 2)
        dims = (1, 2, 3)
        coord_loss = self.lambda_coord * torch.sum(resp * (pos + size), dim=dims)
        conf_obj = torch.sum(resp * (conf - ious.detach()) ** 2, dim=dims)
        conf_noobj = self.lambda_no_obj * torch.sum((1.0 - resp) * conf ** 2, dim=dims)
        log_p = torch.log_softmax(cls_logits, dim=-1)
        ce = -torch.sum(gt_cls[..., None, :] * log_p, dim=-1)
        cls_loss = torch.sum(resp * ce, dim=dims)

        total = coord_loss + conf_obj + conf_noobj + cls_loss
        if mask is not None:
            total = total * mask.reshape(total.shape)
        return total

    def get_predicted_objects(self, activated, threshold: float = 0.5
                              ) -> List[DetectedObject]:
        """Decode :meth:`apply`'s output (a tensor or an array) into the
        boxes whose confidence exceeds ``threshold``, on the host."""
        if isinstance(activated, torch.Tensor):
            activated = activated.detach().float().cpu().numpy()
        a = np.asarray(activated)
        b, h, w, d = a.shape
        a5 = a.reshape(b, h, w, self.n_boxes, d // self.n_boxes)
        out: List[DetectedObject] = []
        for ex in range(b):
            conf = a5[ex, ..., 4]  # (H,W,B)
            ys, xs, bs = np.where(conf > threshold)
            for y, x_, bi in zip(ys, xs, bs):
                box = a5[ex, y, x_, bi]
                probs = box[5:]
                out.append(DetectedObject(
                    ex, float(box[0] + x_), float(box[1] + y), float(box[2]), float(box[3]),
                    int(np.argmax(probs)), float(conf[y, x_, bi]), probs.copy()))
        return out
