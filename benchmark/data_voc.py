"""A seeded dataset in the Pascal VOC 2012 layout, for the ``train`` mix.

    <root>/VOCdevkit/VOC2012/JPEGImages/<name>.jpg
    <root>/VOCdevkit/VOC2012/SegmentationClassAug/<name>.png
    <root>/VOCdevkit/VOC2012/ImageSets/Segmentation/train_aug.txt

The program's plain VOC source reads its training list from
``train_aug.txt``; the list here has 1,464 names, the size of VOC 2012's
``train`` split (the 1,464 segmentation-annotated training images of the
challenge; VOC Aug's 10,582 would cache ~11 GiB on the card and take
minutes to write and decode in every run).

Every image has one of VOC's own sizes: a long side of 500 and a short
side of 281 to 500, landscape and portrait, in VOC's rough proportions.
The multiset of sizes is the same for every seed; the seed permutes it and
draws the content, so every seed asks the same work of the data path.

Content: a background (class 0) with one to three elliptic objects of
classes 1 to 20, and VOC's ``void`` border (label 255) two pixels wide
around each object's outline; the image is a per-class colour with smooth
low-frequency shading and fine noise, saved as a JPEG of quality 90 (about
30 KB), the label as an 8-bit PNG.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

NUM_CLASSES = 21
VOID = 255
TRAIN_IMAGES = 1464
# (height, width, count): 1,110 landscape and 354 portrait images
SIZES = ((375, 500, 600), (333, 500, 250), (334, 500, 60), (332, 500, 40),
         (281, 500, 40), (366, 500, 40), (400, 500, 40), (353, 500, 30),
         (500, 500, 10), (500, 375, 250), (500, 333, 70), (500, 334, 20),
         (500, 281, 14))
BORDER = 2


def size_list(n: int = TRAIN_IMAGES) -> list[tuple[int, int]]:
    """The n sizes in table order (the table's proportions, cut or
    repeated to n)."""
    sizes = [(h, w) for h, w, c in SIZES for _ in range(c)]
    return [sizes[i % len(sizes)] for i in range(n)]


def sample_names(n: int = TRAIN_IMAGES) -> list[str]:
    return [f"2007_{i:06d}" for i in range(n)]


def make_samples(seed: int, sizes, device, first: int = 0):
    """Images (n, 500, 500, 3) uint8 and labels (n, 500, 500) uint8 on
    ``device`` for samples ``first`` .. ``first`` + n − 1 of sizes
    ``sizes`` (each sample's pixels at the origin, (h, w) of them valid),
    drawn in a few large calls from a generator seeded by (seed, first)."""
    import torch
    import torch.nn.functional as F

    n, side = len(sizes), 500
    gen = torch.Generator(device=device).manual_seed(int(seed) * 100003 + int(first))

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    hw = torch.tensor(sizes, dtype=torch.float32, device=device)  # (n, 2)
    yy = torch.arange(side, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(side, dtype=torch.float32, device=device)[None, None, :]
    label = torch.zeros((n, side, side), dtype=torch.uint8, device=device)
    count = (rand(n) * 3).long() + 1  # 1..3 objects
    for k in range(3):
        c = (0.2 + 0.6 * rand(n, 2)) * hw
        r = (0.1 + 0.3 * rand(n, 2)) * hw
        cls = (rand(n) * (NUM_CLASSES - 1)).long() + 1
        inside = (((yy - c[:, 0, None, None]) / r[:, 0, None, None]) ** 2
                  + ((xx - c[:, 1, None, None]) / r[:, 1, None, None]) ** 2) <= 1.0
        inside &= (k < count)[:, None, None]
        label = torch.where(inside, cls[:, None, None].to(torch.uint8), label)
    # the void band: pixels within BORDER of a pixel of another class
    lf = label.float()[:, None]
    k = 2 * BORDER + 1
    hi = F.max_pool2d(lf, k, 1, BORDER)
    lo = -F.max_pool2d(-lf, k, 1, BORDER)
    edge = (hi != lo)[:, 0]
    palette = 30.0 + 195.0 * rand(n, NUM_CLASSES, 3)
    coarse = torch.randn((n, 3, side // 32 + 2, side // 32 + 2), generator=gen, device=device)
    shade = F.interpolate(20.0 * coarse, size=(side, side), mode="bilinear",
                          align_corners=True).permute(0, 2, 3, 1)
    noise = torch.randint(-6, 7, (n, side, side, 3), generator=gen, device=device)
    image = torch.gather(palette, 1, label.long().reshape(n, -1, 1).expand(-1, -1, 3))
    image = image.reshape(n, side, side, 3) + shade + noise
    label = torch.where(edge, torch.full_like(label, VOID), label)
    return image.round().clamp(0, 255).to(torch.uint8), label


def write_tree(root: str, seed: int, device, n: int = TRAIN_IMAGES, threads: int = 8,
               chunk: int = 256) -> list[str]:
    """Write the n-sample tree under ``root``: pixels drawn on ``device``
    in chunks, encoded on the host by ``threads`` threads.  Returns the
    sample names in list order."""
    from PIL import Image

    voc = os.path.join(root, "VOCdevkit", "VOC2012")
    img_dir, lab_dir = os.path.join(voc, "JPEGImages"), os.path.join(voc, "SegmentationClassAug")
    sets = os.path.join(voc, "ImageSets", "Segmentation")
    for d in (img_dir, lab_dir, sets):
        os.makedirs(d, exist_ok=True)
    names = sample_names(n)
    table = size_list(n)
    order = np.random.default_rng([int(seed), n]).permutation(n)
    sizes = [table[j] for j in order]

    def save(i: int, image: np.ndarray, label: np.ndarray) -> None:
        h, w = sizes[i]
        Image.fromarray(image[:h, :w]).save(os.path.join(img_dir, names[i] + ".jpg"), quality=90)
        Image.fromarray(label[:h, :w]).save(os.path.join(lab_dir, names[i] + ".png"),
                                            compress_level=1)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        futures = []
        for start in range(0, n, chunk):
            part = sizes[start:start + chunk]
            image, label = make_samples(seed, part, device, first=start)
            image, label = image.cpu().numpy(), label.cpu().numpy()
            futures += [pool.submit(save, start + j, image[j], label[j]) for j in range(len(part))]
        for f in futures:
            f.result()
    with open(os.path.join(sets, "train_aug.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names


def sample_paths(root: str, name: str) -> tuple[str, str]:
    voc = os.path.join(root, "VOCdevkit", "VOC2012")
    return (os.path.join(voc, "JPEGImages", name + ".jpg"),
            os.path.join(voc, "SegmentationClassAug", name + ".png"))
