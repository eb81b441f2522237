"""Video and image-folder IO on the host (``data/video.py``): lazy frame
readers for video files (imageio) and image folders (PIL) in natural
order, an aspect-preserving centre crop and resize to a target shape, and
a PNG writer. Frames are (H, W, 3) uint8 numpy arrays. Without imageio a
video file cannot be read: the reader raises, and an image folder is the
way in."""
from __future__ import annotations

import os
from typing import List

import numpy as np


def _imageio():
    try:
        import imageio
        return imageio
    except ImportError as e:
        raise ImportError("video IO requires imageio; install it or use an "
                          "image folder") from e


class LowMemoryVideo:
    """A video file's frames, decoded one at a time."""

    def __init__(self, file_name):
        self.reader = _imageio().get_reader(file_name)

    def __len__(self):
        return self.reader.count_frames()

    def __getitem__(self, item) -> np.ndarray:
        return np.asarray(self.reader.get_data(item))[..., :3]

    def __del__(self):
        reader = getattr(self, "reader", None)
        if reader is not None:
            try:
                reader.close()
            except Exception:             # noqa: BLE001  (interpreter exit)
                pass


def split_file_name(file_name: str) -> tuple:
    """Natural sort key: runs of digits compare as numbers."""
    result: List = []
    number = -1
    for ch in file_name:
        if "0" <= ch <= "9":
            number = (0 if number == -1 else number) * 10 + ord(ch) - ord("0")
        else:
            if number != -1:
                result.append(number)
                number = -1
            result.append(ch)
    if number != -1:
        result.append(number)
    return tuple(result)


def search_for_images(folder: str) -> List[str]:
    """The folder's ``.jpg`` and ``.png`` files in natural order."""
    files = [f for f in os.listdir(folder)
             if f.endswith(".jpg") or f.endswith(".png")]
    return [os.path.join(folder, f)
            for f in sorted(files, key=split_file_name)]


class LowMemoryImageFolder:
    """An image folder's frames, read one at a time as RGB."""

    def __init__(self, folder: str):
        self.file_list = search_for_images(folder)

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, item) -> np.ndarray:
        from PIL import Image
        return np.asarray(Image.open(self.file_list[item]).convert("RGB"))


def crop_and_resize(image: np.ndarray, height: int, width: int
                    ) -> np.ndarray:
    """Centre crop to the target's aspect ratio, then PIL's bicubic resize
    to (height, width)."""
    from PIL import Image
    image_height, image_width = image.shape[:2]
    if image_height / image_width < height / width:
        cropped_width = int(image_height / height * width)
        left = (image_width - cropped_width) // 2
        image = image[:, left:left + cropped_width]
    else:
        cropped_height = int(image_width / width * height)
        top = (image_height - cropped_height) // 2
        image = image[top:top + cropped_height, :]
    return np.asarray(Image.fromarray(image).resize((width, height)))


class VideoData:
    """Frames of a video file or an image folder, cropped and resized to
    (height, width) when both are given."""

    def __init__(self, video_file=None, image_folder=None, height=None,
                 width=None):
        if video_file is not None:
            self.data = LowMemoryVideo(video_file)
        elif image_folder is not None:
            self.data = LowMemoryImageFolder(image_folder)
        else:
            raise ValueError("Cannot open video or image folder")
        self.height, self.width = height, width

    def __len__(self):
        return len(self.data)

    def __getitem__(self, item) -> np.ndarray:
        frame = self.data[item]
        if self.height is not None and self.width is not None:
            if frame.shape[:2] != (self.height, self.width):
                frame = crop_and_resize(frame, self.height, self.width)
        return frame


def save_frames(frames, save_path):
    """Frames -> ``save_path/{i}.png``."""
    from PIL import Image
    os.makedirs(save_path, exist_ok=True)
    for i, frame in enumerate(frames):
        Image.fromarray(np.asarray(frame)).save(
            os.path.join(save_path, f"{i}.png"))
