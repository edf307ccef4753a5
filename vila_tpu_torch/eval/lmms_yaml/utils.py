"""lmms-eval `!function` shim.

lmms-eval resolves `!function mod.fn` by loading `<yaml_dir>/<mod>.py` as a
standalone file (lm-eval's `import_function`: spec_from_file_location on
os.path.join(yaml_dir, module + ".py")) — a dotted package path like
`vila_tpu_torch.eval.lmms_tasks.fn` would be looked up as a file named
`vila_tpu_torch.eval.lmms_tasks.py` next to the yaml and fail. The yamls
therefore reference `utils.<fn>` and this file re-exports the task
functions. Because it is exec'd as a loose module, `vila_tpu_torch` may not
be on sys.path yet; fix that relative to this file's location.
"""

import os
import sys

_repo_root = os.path.dirname(  # lmms_yaml/ -> eval/ -> vila_tpu_torch/ -> repo
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)
if _repo_root not in sys.path:
    sys.path.insert(0, _repo_root)

from vila_tpu_torch.eval.lmms_tasks import (  # noqa: E402,F401
    doc_to_text,
    doc_to_text_subtitle,
    doc_to_text_subtitle_env,
    doc_to_visual,
    parse_mc_answer,
    process_results,
)
