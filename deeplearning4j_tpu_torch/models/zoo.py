"""ZooModel base: build and initialize a zoo architecture, or restore its
pretrained weights.

Counterpart of ``deeplearning4j_tpu/models/zoo.py``. ``init_pretrained``
is the reference's ``initPretrained``: it resolves the weight artifact (a
checkpoint zip, ``train/model_serializer.py``) at ``path`` or in the cache
(``$DL4J_TPU_DATA/zoo``, default ``~/.deeplearning4j_tpu/zoo``); when the
cache lacks it and the class registers a URL for the dataset, it downloads
it there (resumable through an HTTP Range request, fsynced, moved into place
atomically); then it holds the file to its sha256 where one is given or
registered (a mismatched file that this call downloaded is deleted, a
staged one kept), and loads it on ``device`` (default the CUDA card).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

CACHE_DIR = os.environ.get(
    "DL4J_TPU_DATA", os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu"))


def _fsync_path(path: str) -> None:
    """Flush a downloaded ``.part`` to disk before its atomic move."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class ZooModel:
    """Subclasses implement ``conf()`` returning a built configuration."""

    name: str = "zoo"

    #: serving hint: whether this architecture tolerates int8 weight-only
    #: quantization of its dense/output heads (per-channel scales,
    #: ``nn/ops/int8_matmul.py``). Use is opt-in (``cli serve
    #: --int8-serving``, ``InferenceEngine(int8_serving=True)``); a model
    #: class that sets this False refuses the flag.
    serving_int8: bool = True

    #: serving hint: sequence-length buckets for rank-3 inputs (the engine
    #: pads time to them under a mask); None for fixed-shape models.
    #: ``cli serve`` reads it when ``--seq-buckets`` is not given.
    serving_seq_buckets: Optional[tuple] = None

    #: per-dataset sha256 hex digests of the weight artifacts
    pretrained_checksums: dict = {}
    #: per-dataset weight-artifact URLs (the reference's ``pretrainedUrl``)
    pretrained_urls: dict = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        # each model class owns its registries: a digest written for one
        # model never shows in another's lookups through the base's dict
        if "pretrained_checksums" not in cls.__dict__:
            cls.pretrained_checksums = dict(cls.pretrained_checksums)
        if "pretrained_urls" not in cls.__dict__:
            cls.pretrained_urls = dict(cls.pretrained_urls)

    def __init__(self, num_classes: int = 1000, seed: int = 123, **kwargs):
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        self.kwargs = kwargs

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build + init the network on ``device`` (default the CUDA card): a
        ``MultiLayerNetwork`` for a list configuration, else a
        ``ComputationGraph``."""
        conf = self.conf()
        for knob in ("compute_dtype", "remat_policy"):
            v = self.kwargs.get(knob)
            if v == "float32" and knob == "compute_dtype":
                v = None  # fp32 is the default: no cast pipeline for no-op casts
            if v is not None and getattr(conf, "global_conf", None) is not None:
                setattr(conf.global_conf, knob, v)
        from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration

        if isinstance(conf, MultiLayerConfiguration):
            from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

            return MultiLayerNetwork(conf).init(device=device)
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        return ComputationGraph(conf).init(device=device)

    # --------------------------------------------------------------- serving
    def serving_input_shape(self) -> Optional[tuple]:
        """The per-example input shape for serving warm-up, from the built
        configuration's input type (None when it declares none)."""
        from deeplearning4j_tpu_torch.serving.engine import conf_example_shape

        return conf_example_shape(self.conf())

    def serving_bucket_policy(self, max_batch: int = 32,
                              batch_buckets: Optional[Sequence[int]] = None):
        """The model's serving bucket policy: the caller's batch buckets and
        this model's ``serving_seq_buckets``."""
        from deeplearning4j_tpu_torch.serving.buckets import BucketPolicy

        return BucketPolicy(batch_buckets=batch_buckets, max_batch=max_batch,
                            seq_buckets=self.serving_seq_buckets)

    # ------------------------------------------------------------ pretrained
    def pretrained_url(self, dataset: str = "imagenet") -> Optional[str]:
        """The URL of the weight artifact for ``dataset``; None when the
        class registers none."""
        return self.pretrained_urls.get(dataset)

    def pretrained_path(self, dataset: str = "imagenet") -> str:
        return os.path.join(CACHE_DIR, "zoo", f"{self.name}_{dataset}.zip")

    @staticmethod
    def _sha256(path: str) -> str:
        import hashlib

        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    @staticmethod
    def _download(url: str, dest: str, timeout: float = 60.0) -> None:
        """Fetch ``url`` into ``dest``: the bytes accumulate in a ``.part``
        file, a later call resumes it with an HTTP Range request, and the
        finished file is fsynced and moved into place atomically. A failed
        fetch raises ``ConnectionError`` naming where to stage the file."""
        import urllib.error
        import urllib.request

        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        part = dest + ".part"
        have = os.path.getsize(part) if os.path.exists(part) else 0
        req = urllib.request.Request(url)
        if have:
            req.add_header("Range", f"bytes={have}-")
        staging = (f"If this environment has no egress, stage the artifact at {dest} "
                   f"manually (partial progress kept at {part}).")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                if have and resp.status != 206:
                    have = 0  # the server ignored the Range: start again
                with open(part, "ab" if have else "wb") as f:
                    for chunk in iter(lambda: resp.read(1 << 20), b""):
                        f.write(chunk)
        except urllib.error.HTTPError as e:
            if e.code == 416 and have:
                # a Range past the end: the .part holds the whole file (a
                # crash between the last read and the move); the checksum
                # gate judges its bytes
                _fsync_path(part)
                os.replace(part, dest)
                return
            raise ConnectionError(
                f"Could not download pretrained weights from {url}: {e}. {staging}") from e
        except (urllib.error.URLError, OSError) as e:
            raise ConnectionError(
                f"Could not download pretrained weights from {url}: {e}. {staging}") from e
        _fsync_path(part)
        os.replace(part, dest)

    def init_pretrained(self, dataset: str = "imagenet", path: Optional[str] = None,
                        checksum: Optional[str] = None, device=None):
        """The pretrained network for ``dataset`` on ``device`` (default the
        CUDA card), from ``path`` or the cache, downloaded into the cache
        when absent there and a URL is registered. ``checksum`` (sha256
        hex) overrides ``pretrained_checksums[dataset]``; where either is
        set the file must match it."""
        explicit_path = path is not None
        path = path or self.pretrained_path(dataset)
        downloaded = False  # only a file this call fetched is deleted on mismatch
        if not os.path.exists(path):
            url = self.pretrained_url(dataset)
            if url is None or explicit_path:
                raise FileNotFoundError(
                    f"No pretrained weights at {path} and no URL registered for "
                    f"{type(self).__name__}[{dataset!r}] (pretrained_urls). Stage a "
                    "checkpoint there or register its URL.")
            self._download(url, path)
            downloaded = True
        expect = checksum or self.pretrained_checksums.get(dataset)
        if expect:
            actual = self._sha256(path)
            if actual != expect.lower():
                if downloaded:
                    os.remove(path)  # the next call downloads it again
                raise ValueError(
                    f"Checksum mismatch for {path}: expected {expect}, got {actual} — "
                    "refusing to load a corrupt/substituted pretrained artifact"
                    + (" (deleted; retry will re-download)" if downloaded else ""))
        from deeplearning4j_tpu_torch.train.model_serializer import ModelGuesser

        return ModelGuesser.load_model_guess(path, device=device)

    initPretrained = init_pretrained
