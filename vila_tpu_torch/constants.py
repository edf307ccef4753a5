"""Framework-wide constants.

Capability parity: reference llava/constants.py:21-48 (media token strings,
IGNORE_INDEX, NUM_EXTRA_TOKENS).
"""

IGNORE_INDEX = -100

# Media sentinel tokens (added to the tokenizer as special tokens).
MEDIA_TOKENS = {
    "image": "<image>",
    "video": "<vila/video>",
}

# Sentinel used during label masking (see data/tokenizer_utils.py).
SENTINEL_TOKEN = "<vila/sentinel>"

# Number of extra token slots reserved on top of the base vocab
# (media tokens + sentinel + padding-to-multiple headroom).
NUM_EXTRA_TOKENS = 8

DEFAULT_IMAGE_TOKEN = MEDIA_TOKENS["image"]
DEFAULT_VIDEO_TOKEN = MEDIA_TOKENS["video"]
