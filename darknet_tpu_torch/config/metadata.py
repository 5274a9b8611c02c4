"""Dataset descriptor (`.data` file) — reference `option_list.cpp:13-131`;
the port's copy of `darknet_tpu/config/metadata.py`.

A `.data` file is flat key=value, e.g.::

    classes = 80
    train   = train.txt
    valid   = val.txt
    names   = coco.names
    save    = save/        (AlexeyAB-style `backup =` also accepted)

`Metadata::Get` (reference `option_list.cpp:40-99`) loads the class-name list
and validates that its length matches `classes`.
"""

from __future__ import annotations

import dataclasses
import os


def read_data_cfg(path) -> dict:
    options: dict[str, str] = {}
    with open(path, "r") as f:
        for raw in f:
            line = "".join(ch for ch in raw if ch not in " \t\n\r")
            if not line or line[0] in "#;":
                continue
            if "=" not in line:
                continue
            key, _, value = line.partition("=")
            options.setdefault(key, value)
    return options


@dataclasses.dataclass
class Metadata:
    classes: int
    names: list[str]
    train_list: str | None = None
    valid_list: str | None = None
    backup_dir: str = "save"     # the reference's default save dir
                                 # (option_list.cpp:49)
    options: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_file(cls, path) -> "Metadata":
        opts = read_data_cfg(path)
        classes = int(opts.get("classes", "2"))
        names_file = opts.get("names")
        names: list[str] = []
        if names_file:
            names_path = names_file
            if not os.path.isabs(names_path):
                # relative to the .data file's directory, then to cwd
                cand = os.path.join(os.path.dirname(str(path)), names_file)
                names_path = cand if os.path.exists(cand) else names_file
            with open(names_path, "r") as f:
                names = [ln.strip() for ln in f if ln.strip()]
            if len(names) != classes:
                # the reference errors out on mismatch (option_list.cpp:79-87)
                raise ValueError(
                    f"names file {names_file} has {len(names)} entries, "
                    f"but classes={classes}"
                )
        else:
            names = [str(i) for i in range(classes)]
        return cls(
            classes=classes,
            names=names,
            train_list=opts.get("train"),
            valid_list=opts.get("valid"),
            # this fork's key is `save` (default "save", option_list.cpp:49);
            # AlexeyAB-style .data files use `backup` — accept both
            backup_dir=opts.get("save", opts.get("backup", "save")),
            options=opts,
        )

    def load_paths(self, which: str = "train") -> list[str]:
        """Load the image-path list file (one path per line)."""
        list_file = self.train_list if which == "train" else self.valid_list
        if not list_file:
            raise ValueError(f"no {which} list in .data file")
        with open(list_file, "r") as f:
            return [ln.strip() for ln in f if ln.strip()]
