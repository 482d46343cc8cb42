"""Client verbs against master + volume servers (weed/operation/).

The port's copy of ``seaweedfs_tpu/operation``.
"""

from .client import (  # noqa: F401
    Assignment,
    assign,
    delete_file,
    lookup,
    read_file,
    upload,
    upload_data,
)
from .watch import (  # noqa: F401
    LocationWatcher,
    get_watcher,
    start_location_watch,
    stop_location_watch,
)
from .submit import submit_file, submit_files  # noqa: F401,E402
