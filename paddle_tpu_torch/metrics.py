"""Streaming Python-side metrics (reference: python/paddle/fluid/metrics.py)."""
from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "Accuracy", "Auc", "Precision", "Recall", "CompositeMetric", "ChunkEvaluator", "DetectionMAP", "EditDistance"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).item()) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data updated into Accuracy metric")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        a = self.tp + self.fn
        return float(self.tp) / a if a else 0.0


class Auc(MetricBase):
    """Streaming AUC via threshold histogram (reference: metrics.py Auc)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        n = self._num_thresholds + 1
        self._stat_pos = np.zeros(n, dtype=np.int64)
        self._stat_neg = np.zeros(n, dtype=np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        bins = np.minimum((pos_prob * self._num_thresholds).astype(int), self._num_thresholds)
        for b, l in zip(bins, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).item())
        self.num_label_chunks += int(np.asarray(num_label_chunks).item())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).item())

    def eval(self):
        precision = self.num_correct_chunks / self.num_infer_chunks if self.num_infer_chunks else 0.0
        recall = self.num_correct_chunks / self.num_label_chunks if self.num_label_chunks else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        return precision, recall, f1


class DetectionMAP(MetricBase):
    """Streaming mean-average-precision over batches (reference:
    python/paddle/fluid/metrics.py DetectionMAP + evaluator.py; the
    per-batch matching mirrors operators/detection/detection_map_op.cc).

    ``update(detections, gt_labels, gt_boxes)`` consumes the padded
    convention: detections [N, K, 6] (label, score, x1, y1, x2, y2 with
    label -1 padding, e.g. multiclass_nms output), gt_labels [N, B],
    gt_boxes [N, B, 4] (zero-area rows are padding).  ``eval()`` returns
    the mAP over every class seen so far.
    """

    def __init__(self, class_num, overlap_threshold=0.5,
                 ap_version="integral", background_label=0, name=None):
        super().__init__(name)
        if ap_version not in ("integral", "11point"):
            raise ValueError("ap_version must be 'integral' or '11point'")
        self.class_num = int(class_num)
        self.overlap_threshold = float(overlap_threshold)
        self.ap_version = ap_version
        self.background_label = background_label
        self.reset()

    def reset(self):
        # per class: number of gt boxes + (score, is_tp) records
        self._n_gt = np.zeros(self.class_num, np.int64)
        self._records = [[] for _ in range(self.class_num)]

    @staticmethod
    def _iou(a, b):
        ix = min(a[2], b[2]) - max(a[0], b[0])
        iy = min(a[3], b[3]) - max(a[1], b[1])
        inter = max(ix, 0.0) * max(iy, 0.0)
        ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gt_labels, gt_boxes):
        det = np.asarray(detections)
        gl = np.asarray(gt_labels)
        gb = np.asarray(gt_boxes)
        if gl.ndim == 3:
            gl = gl[..., 0]
        N = det.shape[0]
        for n in range(N):
            valid_gt = (gb[n, :, 2] - gb[n, :, 0] > 1e-6) & (
                gb[n, :, 3] - gb[n, :, 1] > 1e-6
            )
            for c in range(self.class_num):
                if c == self.background_label:
                    continue  # excluded from mAP, like the detection_map op
                gt_idx = np.nonzero(valid_gt & (gl[n] == c))[0]
                self._n_gt[c] += len(gt_idx)
                dets_c = [
                    (float(d[1]), d[2:6])
                    for d in det[n]
                    if int(d[0]) == c and d[1] > -1
                ]
                dets_c.sort(key=lambda t: -t[0])
                used = set()
                for score, box in dets_c:
                    # VOC matching (detection_map_op.cc): judge against
                    # the overall max-IoU gt; if it's taken -> FP (no
                    # fall-through to the next-best gt)
                    best, best_iou = -1, 0.0
                    for gi in gt_idx:
                        iou = self._iou(box, gb[n, gi])
                        if iou > best_iou:
                            best, best_iou = gi, iou
                    if (
                        best >= 0
                        and best_iou >= self.overlap_threshold
                        and best not in used
                    ):
                        used.add(best)
                        self._records[c].append((score, 1))
                    else:
                        self._records[c].append((score, 0))

    def eval(self):
        aps, n_classes = [], 0
        for c in range(self.class_num):
            if self._n_gt[c] == 0 or c == self.background_label:
                continue
            n_classes += 1
            recs = sorted(self._records[c], key=lambda t: -t[0])
            tp = np.cumsum([r[1] for r in recs]) if recs else np.zeros(0)
            fp = np.cumsum([1 - r[1] for r in recs]) if recs else np.zeros(0)
            if len(recs) == 0:
                aps.append(0.0)
                continue
            recall = tp / max(self._n_gt[c], 1)
            precision = tp / np.maximum(tp + fp, 1e-10)
            if self.ap_version == "11point":
                ap = np.mean([
                    max(precision[recall >= r], default=0.0)
                    if (recall >= r).any() else 0.0
                    for r in np.linspace(0, 1, 11)
                ])
            else:
                drecall = np.diff(recall, prepend=0.0)
                ap = float(np.sum(precision * drecall))
            aps.append(float(ap))
        return float(np.mean(aps)) if n_classes else 0.0


class EditDistance(MetricBase):
    """Streaming average edit distance (reference: fluid/metrics.py
    EditDistance) — feed the edit_distance op's (distances,
    seq_num) per batch."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        import numpy as np

        d = np.asarray(distances).reshape(-1)
        self.total_distance += float(d.sum())
        self.seq_num += int(np.asarray(seq_num))
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data fed to EditDistance")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)
