"""TenniSet index (counterpart of ``tennis_tpu/data/tennis_set.py``):
``TennisSet`` for frame classification and feature dumps (samples, labels,
events, seeded class balancing, windows, frame and feature loading, feature
dump paths) and, with ``captions=True``, for the captioner (the split's
points, the caption vocabulary, caption ids, bucketing lengths); and the
caption index ``CaptionIndex`` that the ``/caption`` service reads. In-band
frame extraction from the source videos (``extract_missing``) and the
native DCT-scaled JPEG decode are not ported yet.

On-disk conventions, as in the JAX package:

- ``<root>/splits/<split_id>/<split>.txt``   lines ``<video> <frame>``
- ``<root>/annotations/labels/<video>.txt``  lines ``<frame> <class>``
- ``<root>/annotations/points.txt``          lines ``<id> <video> <start> <end> <x>``
- ``<root>/annotations/captions.txt``        lines ``<id>\\t<caption>``
- frames and features chunked as
  ``<dir>/<video>.mp4/<chunk:010d>/<frame:010d>.{jpg,npy}``, chunk = frame
  // 1000 * 1000
"""
from __future__ import annotations

import math
import os
from collections import OrderedDict

import numpy as np

from tennis_torch.data.vocab import Vocab, captions_vocab

CHUNK_SIZE = 1000

DEFAULT_CLASSES = [
    "OTH", "SFI", "SFF", "SFL", "SNI", "SNF", "SNL", "HFL", "HFR", "HNL", "HNR",
]


def load_classes(root: str = "data") -> list[str]:
    """Class list from ``<root>/classes.names``, falling back to the canonical
    11 TenniSet classes when the file is absent."""
    names_file = os.path.join(root, "classes.names")
    if os.path.exists(names_file):
        with open(names_file, "r") as f:
            return [line.strip() for line in f if line.strip()]
    return list(DEFAULT_CLASSES)


def get_image_path(root_dir, video_name, frame_number, chunk_size=CHUNK_SIZE):
    chunk = int(frame_number / chunk_size) * chunk_size
    return os.path.join(root_dir, video_name + ".mp4", f"{chunk:010d}",
                        f"{frame_number:010d}.jpg")


def get_feature_path(feat_dir, video_name, frame_number, chunk_size=CHUNK_SIZE):
    chunk = int(frame_number / chunk_size) * chunk_size
    return os.path.join(feat_dir, video_name + ".mp4", f"{chunk:010d}",
                        f"{frame_number:010d}.npy")


def load_points(root: str, split: str = "train",
                split_id: str = "02") -> "OrderedDict[str, list]":
    """The captioned points of a split: ``{point_id: [video, start, end, x,
    caption]}`` in ``points.txt`` order, keeping a point only when its start
    frame is one of the split's frames that exist on disk (the JAX
    ``TennisSet`` index: split file, frame-existence filter, labels)."""
    splits_file = os.path.join(root, "splits", split_id, split + ".txt")
    if not os.path.exists(splits_file):
        raise FileNotFoundError(
            f"Split file {splits_file} does not exist; cannot load dataset.")
    with open(splits_file, "r") as f:
        samples = [[line.split()[0], int(line.split()[1])]
                   for line in f if line.strip()]
    videos = list(OrderedDict.fromkeys(s[0] for s in samples))
    frames_dir = os.path.join(root, "frames")
    samples = [s for s in samples
               if os.path.exists(get_image_path(frames_dir, s[0], s[1]))]
    labels = {v: {} for v in videos}
    for v in videos:
        with open(os.path.join(root, "annotations", "labels", v + ".txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    labels[v][int(parts[0])] = parts[1]
    in_set = {v: set() for v in videos}
    for v, frame in samples:
        if frame not in labels[v]:  # the JAX index raises here too
            raise KeyError(f"frame {frame} of {v} has no label")
        in_set[v].add(frame)

    return read_points(root, in_set)


def read_points(root: str, in_set: dict) -> "OrderedDict[str, list]":
    """``{point_id: [video, start, end, x, caption]}`` in ``points.txt``
    order, for the points whose start frame is in ``in_set[video]`` (a set
    of the split's frames on disk); empty without the annotation files."""
    points = OrderedDict()
    points_path = os.path.join(root, "annotations", "points.txt")
    caps_path = os.path.join(root, "annotations", "captions.txt")
    if os.path.exists(points_path) and os.path.exists(caps_path):
        with open(points_path, "r") as f:
            rows = [line.split() for line in f if line.strip()]
        caps = {}
        with open(caps_path, "r") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    caps[parts[0]] = parts[1]
        for p in rows:
            cap = caps[p[0]]
            if p[1] in in_set and int(p[2]) in in_set[p[1]]:
                points[p[0]] = p[1:] + [cap]
    return points


def caption_ids(vocab: Vocab, caption: str, max_cap_len: int = -1):
    """int32 token ids ``BOS w_1 ... w_n EOS`` of a caption, its words cut
    to ``max_cap_len`` when that is >= 0."""
    toks = caption.split()
    if max_cap_len >= 0:
        toks = toks[:max_cap_len]
    return np.asarray([vocab[vocab.bos_token]] + vocab[toks]
                      + [vocab[vocab.eos_token]], dtype=np.int32)


class CaptionIndex:
    """The caption side of the JAX ``TennisSet(captions=True)``: the split's
    points, the caption vocabulary (built from this split's captions unless
    one is given: the train split's is the one checkpoints index into), the
    token ids of each caption (BOS ... EOS, truncated to ``max_cap_len``
    words when >= 0), and the feature paths of each point's frames."""

    def __init__(self, root: str = "data", split: str = "train",
                 split_id: str = "02", every: int = 1, max_cap_len: int = -1,
                 vocab: Vocab | None = None, feats_model: str | None = None,
                 model_id: str = "0000"):
        self._every = every
        self.points = load_points(root, split, split_id)
        self.samples = list(self.points)
        self.feat_dir = os.path.join(root, "features",
                                     feats_model if feats_model else model_id)
        self.vocab = vocab if vocab is not None else captions_vocab(
            [p[4] for p in self.points.values()])
        self.caption_ids = {point_id: caption_ids(self.vocab, p[4], max_cap_len)
                            for point_id, p in self.points.items()}

    def __len__(self) -> int:
        return len(self.samples)

    def frames(self, idx: int) -> list[int]:
        """Frame numbers of point ``idx``: every ``every``-th of [start, end)."""
        _, start, end = self.points[self.samples[idx]][:3]
        return [f for c, f in enumerate(range(int(start), int(end)))
                if c % self._every == 0]

    def feature_path(self, idx: int, frame: int) -> str:
        return get_feature_path(self.feat_dir, self.points[self.samples[idx]][0],
                                frame)


def _read_image_rgb(path: str, min_short: int | None = None) -> np.ndarray:
    """RGB uint8 read with cv2, at full size. ``min_short`` is the bound the
    JAX package's native libjpeg path gives its DCT-scaled decode of
    sources at least twice that size; the port decodes them whole (the
    native decoder waits for a later slice), which is bit-identical with it
    below that size."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class TennisSet:
    """Index over the TenniSet frames and labels for frame classification
    and feature dumps, or over its captioned points with ``captions=True``.

    ``__getitem__`` returns ``(img, label, idx)``: img is (H, W, C) uint8,
    (window, H, W, C) uint8 for ``window > 1``, or the float32 features of
    ``feats_model`` when given. In captions mode it returns ``(imgs,
    cap_ids, n_imgs, n_cap)``, with ``idx`` appended when ``inference``:
    every ``every``-th frame (or feature) of the point stacked, and the
    int32 caption ids (``BOS ... EOS``, words cut to ``max_cap_len`` when
    >= 0) in ``vocab``, by default the one built from this split's captions
    (the train split's is the one checkpoints index into). Class balancing
    of 'OTH' is seeded (``balance_seed``). ``save_feats`` extends each
    video's frames by 255 on either side, labelled 'OTH', before the
    existence filter, so temporal models get context features at event
    boundaries. Frames missing on disk
    are dropped.
    """

    def __init__(self, root="data", transform=None, split="train", every=1,
                 balance=True, padding=1, stride=1, window=1,
                 model_id="0000", split_id="02", flow=False,
                 feats_model=None, save_feats=False, balance_seed: int = 0,
                 decode_short: int | None = None,
                 frames_cache: int | None = None, captions: bool = False,
                 max_cap_len: int = -1, vocab: Vocab | None = None,
                 inference: bool = False):
        self._decode_short = decode_short
        self._captions = captions
        self._inference = inference
        # the pre-resized mirror, with per-file fallback; off for the
        # 6-channel path, whose 8-row crop needs the on-disk geometry
        self._frames_cache_dir = None
        self._frames_cache_short = None
        if frames_cache and not flow:
            from tennis_torch.data.frame_cache import cache_dir

            self._frames_cache_dir = cache_dir(root, int(frames_cache))
            self._frames_cache_short = int(frames_cache)
        self._split = split
        self._every = every
        self._padding = padding  # a flag of the reference, unused there too
        self._stride = stride
        self._window = window
        self._transform = transform
        self._flow = flow
        self._save_feats = save_feats

        self._frames_dir = os.path.join(root, "frames")
        self._flow_dir = os.path.join(root, "flow")
        self._splits_dir = os.path.join(root, "splits")
        self._labels_dir = os.path.join(root, "annotations", "labels")
        self._load_feats = feats_model is not None
        self.feat_dir = os.path.join(root, "features",
                                     feats_model if self._load_feats
                                     else model_id)
        self.classes = load_classes(root)

        self._samples, self._videos, self._events = self._load_data(split_id)
        self._video_lengths = self._get_video_lengths()
        if captions:
            self._points = read_points(root, {
                v: {s[1] for s in self._samples if s[0] == v}
                for v in self._videos})
            self._samples = list(self._points)
            self.vocab = vocab if vocab is not None else captions_vocab(
                [p[4] for p in self._points.values()])
            for p in self._points.values():
                p.append(caption_ids(self.vocab, p[4], max_cap_len))
        elif balance:
            self._samples = self._balance_classes(balance_seed)

    # ------------------------------------------------------------ loading

    def _load_data(self, split_id):
        from tennis_torch.utils import Progress

        splits_file = os.path.join(self._splits_dir, split_id,
                                   self._split + ".txt")
        if not os.path.exists(splits_file):
            raise FileNotFoundError(
                f"Split file {splits_file} does not exist; cannot load dataset.")
        with open(splits_file, "r") as f:
            samples = [[line.split()[0], int(line.split()[1])]
                       for line in f if line.strip()]
        videos = list(OrderedDict.fromkeys(s[0] for s in samples))
        labels = {v: {} for v in videos}

        if self._save_feats:
            # 255 frames of context past each end of a video's range
            for v in videos:
                frames = [s[1] for s in samples if s[0] == v]
                min_f, max_f = min(frames), max(frames)
                for i in range(1, 256):
                    samples.append([v, min_f - i])
                    samples.append([v, max_f + i])
                    labels[v][min_f - i] = "OTH"
                    labels[v][max_f + i] = "OTH"

        samples = [
            s for s in Progress.wrap(samples, f"scanning {self._split} frames",
                                     unit="frames", interval=30.0)
            if os.path.exists(get_image_path(self._frames_dir, s[0], s[1]))]

        for v in videos:
            with open(os.path.join(self._labels_dir, v + ".txt"), "r") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        labels[v][int(parts[0])] = parts[1]

        in_set = {v: [] for v in videos}
        for s in samples:
            s.append(labels[s[0]][s[1]])
            in_set[s[0]].append(s[1])

        # events: maximal runs of one label over the sorted in-split frames;
        # as in the reference, the first run of a video starts as 'OTH'
        events = []
        for v in videos:
            cur_class, start_frame, last_frame = "OTH", -1, -1
            for frame in sorted(in_set[v]):
                if start_frame < 0:
                    start_frame = last_frame = frame
                if labels[v][frame] != cur_class:
                    events.append([v, start_frame, last_frame, cur_class])
                    cur_class = labels[v][frame]
                    start_frame = frame
                last_frame = frame
            events.append([v, start_frame, last_frame, cur_class])
        return samples, videos, events

    def _get_video_lengths(self):
        """Largest extracted frame number of each video, from the chunked
        frames layout, walking back over empty trailing chunk dirs."""
        lengths = {}
        for sample in self._samples:
            v = sample[0]
            if v in lengths:
                continue
            vdir = os.path.join(self._frames_dir, v + ".mp4")
            if not os.path.isdir(vdir):
                lengths[v] = max(s[1] for s in self._samples if s[0] == v)
                continue
            chunks = sorted(d for d in os.listdir(vdir) if d.isdigit())
            for chunk in reversed(chunks):
                files = sorted(os.listdir(os.path.join(vdir, chunk)))
                if files:
                    lengths[v] = int(os.path.splitext(files[-1])[0])
                    break
            else:
                raise FileNotFoundError(f"no extracted frames under {vdir}")
        return lengths

    # ---------------------------------------------------------- balancing

    def _balance_classes(self, seed: int):
        """Downsample 'OTH' to the next most frequent class in expectation,
        with a seeded generator."""
        counts = self.class_counts()
        ratio = max(counts[1:]) / float(counts[0] + 1)
        rng = np.random.default_rng(seed)
        return [s for s in self._samples
                if not (s[2] == "OTH" and rng.uniform(0.0, 1.0) > ratio)]

    def class_counts(self):
        counts = [0] * len(self.classes)
        index = {c: i for i, c in enumerate(self.classes)}
        for s in self._samples:
            counts[index[s[2]]] += 1
        return counts

    @property
    def num_class(self):
        return len(self.classes)

    def __len__(self):
        return len(self._samples)

    # ----------------------------------------------------------- sampling

    def _load_frame(self, video, frame):
        if self._load_feats:
            return np.load(get_feature_path(self.feat_dir, video, frame))
        min_short = None if self._flow else self._decode_short
        path = get_image_path(self._frames_dir, video, frame)
        cache_miss_short = None
        if self._frames_cache_dir is not None:
            cached = get_image_path(self._frames_cache_dir, video, frame)
            if os.path.exists(cached):
                path = cached
            else:
                # a miss takes the cache's geometry, so that one window
                # never mixes resolutions
                cache_miss_short = self._frames_cache_short
        img = _read_image_rgb(path, min_short)
        if cache_miss_short is not None and min(img.shape[:2]) > cache_miss_short:
            from tennis_torch.data.transforms import resize_shorter

            img = resize_shorter(img, cache_miss_short)
        if self._flow:
            flw = _read_image_rgb(get_image_path(self._flow_dir, video, frame))
            # flow frames are 16 rows shorter: crop 8 rows off each end of
            # the RGB frame before the 6-channel concat
            img = np.concatenate([img[8:-8], flw], axis=-1)
        return img

    def _max_every_frame(self, video):
        """Largest frame index that is a multiple of ``every``."""
        max_frame = self._video_lengths[video] - self._every
        for i in range(self._every):
            if (max_frame - i) % self._every == 0:
                max_frame -= i
                break
        return max_frame

    def window_frames(self, idx):
        """Frame numbers of the temporal window of sample ``idx``."""
        sample = self._samples[idx]
        offsets = range(int(-self._window / 2), int(math.ceil(self._window / 2)))
        max_frame = self._max_every_frame(sample[0])
        return [min(max(0, sample[1] + o * self._stride), int(max_frame))
                for o in offsets]

    def __getitem__(self, idx):
        if self._captions:
            video, start, end, _, _, cap = self._points[self._samples[idx]]
            imgs = []
            for c, f in enumerate(range(int(start), int(end))):
                if c % self._every == 0:
                    img = self._load_frame(video, f)
                    if self._transform is not None:
                        img = self._transform(img)
                    imgs.append(img)
            imgs = np.stack(imgs)
            if self._inference:
                return imgs, cap, len(imgs), len(cap), idx
            return imgs, cap, len(imgs), len(cap)
        sample = self._samples[idx]
        label = self.classes.index(sample[2])
        if self._window > 1:
            imgs = []
            for frame in self.window_frames(idx):
                img = self._load_frame(sample[0], frame)
                if self._transform is not None:
                    img = self._transform(img)
                imgs.append(img)
            img = np.stack(imgs)
        else:
            img = self._load_frame(sample[0], sample[1])
            if self._transform is not None:
                img = self._transform(img)
        return img, label, idx

    # ----------------------------------------------------------- captions

    def get_captions(self, ids=False, split=False):
        """Each point's caption: the string, its words (``split``), or its
        ids (``ids``)."""
        caps = []
        for point_id in self._samples:
            cap = self._points[point_id][5 if ids else 4]
            caps.append(cap.split() if split and not ids else cap)
        return caps

    def get_data_lens(self):
        """(frames, caption ids) of each point, the bucketing keys. The
        frame count is ``(end - start + 1) / every`` rounded down, as the
        JAX package counts it."""
        if not self._captions:
            raise ValueError("get_data_lens needs captions=True")
        return [(int((int(p[2]) - int(p[1]) + 1) / self._every), len(p[5]))
                for p in (self._points[i] for i in self._samples)]

    def save_feature_path(self, idx, chunk_size=CHUNK_SIZE):
        sample = self._samples[idx]
        return get_feature_path(self.feat_dir, sample[0], sample[1], chunk_size)

    # ---------------------------------------------------------- reporting

    def stats(self):
        if self._captions:
            frames = sum(int(self._points[s][2]) - int(self._points[s][1])
                         for s in self._samples)
            points = len(self._samples)
            return (f"Split: {self._split}\n"
                    + "{0: <8} {1: <8} {2: <5}\n".format(
                        "# Points", "# Frames", "FperP")
                    + "{0: <8} {1: <8} {2: <5}\n".format(
                        points, frames, int(frames / max(points, 1))))
        frame_counts = self.class_counts()
        event_counts = [0] * len(self.classes)
        index = {c: i for i, c in enumerate(self.classes)}
        for e in self._events:
            event_counts[index[e[3]]] += 1
        out = f"Split: {self._split}\n"
        out += "{0: <6} {1: <8} {2: <8} {3: <5}\n".format(
            "Class", "# Frames", "# Events", "FperE")
        for i, c in enumerate(self.classes):
            out += "{0: <6} {1: <8} {2: <8} {3: <5}\n".format(
                c, frame_counts[i], event_counts[i],
                int(frame_counts[i] / (event_counts[i] + 1e-5)))
        return out

    def __str__(self):
        return "\n\n" + self.__class__.__name__ + "\n" + self.stats() + "\n"
