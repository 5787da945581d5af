"""Command-line help texts of the tutorial project (a copy of
`xframe_tpu.projects.tutorial._argparser_`)."""

PROJECT_DESCRIPTION = "Minimal example project (framework walkthrough)."

WORKER_HELP = {
    "get_started": ("minimal example worker",
                    "Runs the minimal example ProjectWorker: demonstrates "
                    "settings access and database saving."),
}
