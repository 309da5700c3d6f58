"""Tkinter desktop client: the reference GUI, rebuilt over `LMSClient`.

The port's copy of `distributed_lms_raft_llm_tpu/client/gui.py`, its
logic as it is. It imports `tkinter` at the top; no other module of the
port imports this one, so a machine without Tk runs everything else.

Capability parity: every screen of the reference Tkinter app (reference:
GUI_RAFT_LLM_SourceCode/lms_gui_final.py — register/login :305-368, student
menu :377-426, view/download course material :474-593, upload assignment
:597-670, view grades :730-838, ask query [instructor | llm] :844-940, view
instructor responses :946-1013; instructor menu :429-468, post course
material :1034-1109, view & grade assignments :1112-1248, respond to query
:1255-1361, logout :1369-1404) over this package's leader-discovering
client library instead of per-call channel dialing.

Deliberate differences from the reference:

- Downloads save the *selected* list entry, not `entries[0]`
  (reference defect D8, lms_gui_final.py:588, 1207).
- RPCs run on one worker thread and marshal results back through
  `Tk.after`, so the UI never blocks on the network and widget access
  stays on the main thread (the reference mutated Tk state from pool
  threads, lms_gui_final.py:112-155).
- Leader discovery/retry/failover live in `LMSClient` (same behavior:
  re-resolve + retry on transient codes).

Headless testing: the module touches the toolkit only through the module
attributes `tk`, `messagebox`, and `filedialog`, so tests substitute fake
widget classes and drive every screen without a display
(tests/test_gui.py); run interactively with
    python -m distributed_lms_raft_llm_tpu_torch.client.gui --servers host:port,...
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import sys
import traceback
from typing import Callable, List, Optional

import tkinter as tk
from tkinter import filedialog, messagebox

from ..utils import pdf as pdf_lib
from .client import LMSClient, NoLeader

TITLE = "Distributed LMS"


class LMSApp:
    """The application: one window, one active screen at a time.

    Every `show_*` method clears the body frame and rebuilds it; every
    network call goes through `_async` (worker thread + `after` marshal)
    unless the app was built with `background=False` (tests).
    """

    def __init__(self, client: LMSClient, root=None, background: bool = True):
        self.client = client
        self.root = root if root is not None else tk.Tk()
        self.background = background
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=2)
            if background
            else None
        )
        self.root.title(TITLE)
        try:
            self.root.geometry("640x480")
        except Exception:
            pass
        self.status = tk.StringVar(master=self.root)
        self.body = tk.Frame(self.root)
        self.body.pack(fill=tk.BOTH, expand=True, padx=12, pady=12)
        self.statusbar = tk.Label(self.root, textvariable=self.status, anchor="w")
        self.statusbar.pack(fill=tk.X, side=tk.BOTTOM)
        self.show_welcome()

    # ------------------------------------------------------------ plumbing

    def run(self) -> None:
        self.root.mainloop()

    def destroy(self) -> None:
        if self._pool:
            self._pool.shutdown(wait=False)
        self.root.destroy()

    def _clear(self) -> None:
        for child in self.body.winfo_children():
            child.destroy()

    def _async(self, fn: Callable, on_done: Callable, what: str = "") -> None:
        """Run `fn()` off the UI thread; call `on_done(result)` back on it.

        Errors surface as a messagebox (leader loss, RPC failure) instead of
        a dead button. In synchronous mode (tests) everything runs inline.
        """
        self.status.set(what or "working…")

        def finish(result, error):
            self.status.set("")
            if error is not None:
                messagebox.showerror(TITLE, f"{what or 'operation'} failed: {error}")
            else:
                on_done(result)

        if not self.background:
            try:
                result, error = fn(), None
            except (NoLeader, Exception) as e:  # noqa: BLE001 — surfaced to user
                result, error = None, e
            finish(result, error)
            return

        def work():
            try:
                result, error = fn(), None
            except Exception as e:  # noqa: BLE001 — surfaced to user
                traceback.print_exc()
                result, error = None, e
            self.root.after(0, lambda: finish(result, error))

        self._pool.submit(work)

    def _header(self, text: str, back: Optional[Callable] = None) -> None:
        row = tk.Frame(self.body)
        row.pack(fill=tk.X)
        tk.Label(row, text=text, font=("TkDefaultFont", 14, "bold")).pack(
            side=tk.LEFT
        )
        if back is not None:
            tk.Button(row, text="Back", command=back).pack(side=tk.RIGHT)

    @staticmethod
    def _entry_row(parent, label: str, show: str = "") -> "tk.Entry":
        row = tk.Frame(parent)
        row.pack(fill=tk.X, pady=4)
        tk.Label(row, text=label, width=14, anchor="w").pack(side=tk.LEFT)
        entry = tk.Entry(row, show=show)
        entry.pack(side=tk.LEFT, fill=tk.X, expand=True)
        return entry

    def _listbox(self, items: List[str]) -> "tk.Listbox":
        box = tk.Listbox(self.body)
        for item in items:
            box.insert(tk.END, item)
        box.pack(fill=tk.BOTH, expand=True, pady=6)
        return box

    @staticmethod
    def _selected(box: "tk.Listbox") -> Optional[int]:
        sel = box.curselection()
        return int(sel[0]) if sel else None

    # ------------------------------------------------------------- screens

    def show_welcome(self) -> None:
        self._clear()
        self._header("Welcome to the LMS")
        tk.Button(self.body, text="Login", command=self.show_login).pack(
            fill=tk.X, pady=4
        )
        tk.Button(self.body, text="Register", command=self.show_register).pack(
            fill=tk.X, pady=4
        )
        tk.Button(self.body, text="Quit", command=self.destroy).pack(
            fill=tk.X, pady=4
        )

    def show_register(self) -> None:
        self._clear()
        self._header("Register", back=self.show_welcome)
        user = self._entry_row(self.body, "Username")
        pw = self._entry_row(self.body, "Password", show="*")
        role = tk.StringVar(master=self.root, value="student")
        row = tk.Frame(self.body)
        row.pack(fill=tk.X, pady=4)
        tk.Radiobutton(row, text="student", variable=role, value="student").pack(
            side=tk.LEFT
        )
        tk.Radiobutton(
            row, text="instructor", variable=role, value="instructor"
        ).pack(side=tk.LEFT)

        def submit():
            username, password = user.get().strip(), pw.get()
            if not username or not password:
                messagebox.showwarning(TITLE, "username and password required")
                return
            self._async(
                lambda: self.client.register(username, password, role.get()),
                lambda resp: (
                    messagebox.showinfo(TITLE, resp.message),
                    self.show_welcome() if resp.success else None,
                ),
                what="registering",
            )

        tk.Button(self.body, text="Register", command=submit).pack(pady=8)

    def show_login(self) -> None:
        self._clear()
        self._header("Login", back=self.show_welcome)
        user = self._entry_row(self.body, "Username")
        pw = self._entry_row(self.body, "Password", show="*")

        def submit():
            username, password = user.get().strip(), pw.get()

            def done(ok: bool):
                if not ok:
                    messagebox.showerror(TITLE, "login failed")
                elif self.client.role == "student":
                    self.show_student_menu()
                else:
                    self.show_instructor_menu()

            self._async(
                lambda: self.client.login(username, password), done, what="logging in"
            )

        tk.Button(self.body, text="Login", command=submit).pack(pady=8)

    def _logout(self) -> None:
        self._async(
            lambda: self.client.logout(),
            lambda _ok: self.show_welcome(),
            what="logging out",
        )

    # ------------------------------------------------------ student screens

    def show_student_menu(self) -> None:
        self._clear()
        self._header("Student menu")
        for text, cmd in [
            ("View course materials", self.show_materials),
            ("Download course material", self.show_download_material),
            ("Upload assignment", self.show_upload_assignment),
            ("View my grade", self.show_grades),
            ("Ask a query", self.show_ask_query),
            ("View instructor responses", self.show_responses),
            ("Logout", self._logout),
        ]:
            tk.Button(self.body, text=text, command=cmd).pack(fill=tk.X, pady=3)

    def show_materials(self) -> None:
        def done(entries):
            self._clear()
            self._header("Course materials", back=self.show_student_menu)
            self._listbox(
                [
                    f"{e.filename}  (by {e.instructor}, {len(e.file)} bytes)"
                    for e in entries
                ]
                or ["(no course materials posted)"]
            )

        self._async(self.client.course_materials, done, what="fetching materials")

    def show_download_material(self) -> None:
        def done(entries):
            self._clear()
            self._header("Download material", back=self.show_student_menu)
            box = self._listbox([e.filename for e in entries])

            def save():
                idx = self._selected(box)
                if idx is None or idx >= len(entries):
                    messagebox.showwarning(TITLE, "select a file first")
                    return
                # The SELECTED entry — the reference saved entries[0] no
                # matter the selection (D8, lms_gui_final.py:588).
                entry = entries[idx]
                default = os.path.basename(entry.filename) or "material.pdf"
                path = filedialog.asksaveasfilename(initialfile=default)
                if not path:
                    return
                with open(path, "wb") as f:
                    f.write(entry.file)
                messagebox.showinfo(TITLE, f"saved {path}")

            tk.Button(self.body, text="Save selected", command=save).pack(pady=6)

        self._async(self.client.course_materials, done, what="fetching materials")

    def show_upload_assignment(self) -> None:
        self._clear()
        self._header("Upload assignment", back=self.show_student_menu)

        def pick_and_upload():
            path = filedialog.askopenfilename(
                filetypes=[("PDF files", "*.pdf"), ("All files", "*")]
            )
            if not path:
                return
            with open(path, "rb") as f:
                content = f.read()
            name = os.path.basename(path)
            self._async(
                lambda: self.client.upload_assignment(name, content),
                lambda ok: messagebox.showinfo(
                    TITLE, "uploaded" if ok else "upload failed"
                ),
                what="uploading",
            )

        tk.Button(self.body, text="Choose PDF…", command=pick_and_upload).pack(pady=6)

        text = tk.Text(self.body, height=8)
        text.pack(fill=tk.BOTH, expand=True, pady=6)

        def upload_typed():
            content = text.get("1.0", tk.END).strip()
            if not content:
                messagebox.showwarning(TITLE, "type some text first")
                return
            blob = pdf_lib.make_pdf(content)
            self._async(
                lambda: self.client.upload_assignment("typed.pdf", blob),
                lambda ok: messagebox.showinfo(
                    TITLE, "uploaded" if ok else "upload failed"
                ),
                what="uploading",
            )

        tk.Button(
            self.body, text="Upload typed text as PDF", command=upload_typed
        ).pack(pady=2)

    def show_grades(self) -> None:
        def done(grade: str):
            self._clear()
            self._header("My grade", back=self.show_student_menu)
            tk.Label(self.body, text=grade or "(not graded yet)").pack(pady=12)

        self._async(self.client.my_grade, done, what="fetching grade")

    def show_ask_query(self) -> None:
        self._clear()
        self._header("Ask a query", back=self.show_student_menu)
        text = tk.Text(self.body, height=6)
        text.pack(fill=tk.BOTH, expand=True, pady=6)
        target = tk.StringVar(master=self.root, value="llm")
        row = tk.Frame(self.body)
        row.pack(fill=tk.X)
        tk.Radiobutton(row, text="LLM tutor", variable=target, value="llm").pack(
            side=tk.LEFT
        )
        tk.Radiobutton(
            row, text="Instructor", variable=target, value="instructor"
        ).pack(side=tk.LEFT)

        def submit():
            query = text.get("1.0", tk.END).strip()
            if not query:
                messagebox.showwarning(TITLE, "type a question first")
                return
            if target.get() == "llm":
                self._async(
                    lambda: self.client.ask_llm(query),
                    lambda resp: messagebox.showinfo(
                        TITLE, resp.response if resp.success else f"rejected: {resp.response}"
                    ),
                    what="asking the LLM tutor",
                )
            else:
                self._async(
                    lambda: self.client.ask_instructor(query),
                    lambda ok: messagebox.showinfo(
                        TITLE, "sent to instructor" if ok else "failed"
                    ),
                    what="sending query",
                )

        tk.Button(self.body, text="Submit", command=submit).pack(pady=6)

    def show_responses(self) -> None:
        def done(entries):
            self._clear()
            self._header("Instructor responses", back=self.show_student_menu)
            self._listbox(
                [e.data.replace("\n", " | ") for e in entries]
                or ["(no responses yet)"]
            )

        self._async(
            self.client.instructor_responses, done, what="fetching responses"
        )

    # --------------------------------------------------- instructor screens

    def show_instructor_menu(self) -> None:
        self._clear()
        self._header("Instructor menu")
        for text, cmd in [
            ("Post course material", self.show_post_material),
            ("View & grade assignments", self.show_grade_assignments),
            ("View unanswered queries", self.show_queries),
            ("Respond to a query", self.show_respond_query),
            ("Logout", self._logout),
        ]:
            tk.Button(self.body, text=text, command=cmd).pack(fill=tk.X, pady=3)

    def show_post_material(self) -> None:
        self._clear()
        self._header("Post course material", back=self.show_instructor_menu)

        def pick_and_post():
            path = filedialog.askopenfilename(
                filetypes=[("PDF files", "*.pdf"), ("All files", "*")]
            )
            if not path:
                return
            with open(path, "rb") as f:
                content = f.read()
            name = os.path.basename(path)
            self._async(
                lambda: self.client.upload_course_material(name, content),
                lambda ok: messagebox.showinfo(
                    TITLE, "posted" if ok else "post failed"
                ),
                what="posting material",
            )

        tk.Button(self.body, text="Choose PDF…", command=pick_and_post).pack(pady=6)

    def show_grade_assignments(self) -> None:
        def done(entries):
            self._clear()
            self._header("Grade assignments", back=self.show_instructor_menu)
            box = self._listbox(
                [f"{e.id}: {e.filename} ({len(e.file)} bytes)" for e in entries]
            )
            grade_entry = self._entry_row(self.body, "Grade")

            def submit():
                idx = self._selected(box)
                grade = grade_entry.get().strip()
                if idx is None or idx >= len(entries):
                    messagebox.showwarning(TITLE, "select a student first")
                    return
                if not grade:
                    messagebox.showwarning(TITLE, "enter a grade")
                    return
                student = entries[idx].id
                self._async(
                    lambda: self.client.grade(student, grade),
                    lambda resp: messagebox.showinfo(TITLE, resp.message),
                    what="grading",
                )

            tk.Button(self.body, text="Submit grade", command=submit).pack(pady=6)

        self._async(self.client.student_assignments, done, what="fetching assignments")

    def show_queries(self) -> None:
        def done(entries):
            self._clear()
            self._header("Unanswered queries", back=self.show_instructor_menu)
            self._listbox(
                [f"{e.id}: {e.data}" for e in entries] or ["(no open queries)"]
            )

        self._async(self.client.unanswered_queries, done, what="fetching queries")

    def show_respond_query(self) -> None:
        def done(entries):
            self._clear()
            self._header("Respond to query", back=self.show_instructor_menu)
            box = self._listbox([f"{e.id}: {e.data}" for e in entries])
            text = tk.Text(self.body, height=5)
            text.pack(fill=tk.BOTH, expand=True, pady=6)

            def submit():
                idx = self._selected(box)
                response = text.get("1.0", tk.END).strip()
                if idx is None or idx >= len(entries):
                    messagebox.showwarning(TITLE, "select a query first")
                    return
                if not response:
                    messagebox.showwarning(TITLE, "type a response")
                    return
                student = entries[idx].id
                self._async(
                    lambda: self.client.respond_to_query(student, response),
                    lambda ok: messagebox.showinfo(
                        TITLE, "responded" if ok else "failed"
                    ),
                    what="responding",
                )

            tk.Button(self.body, text="Send response", command=submit).pack(pady=6)

        self._async(self.client.unanswered_queries, done, what="fetching queries")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--servers",
        default="127.0.0.1:50051,127.0.0.1:50052,127.0.0.1:50053,"
                "127.0.0.1:50055,127.0.0.1:50056",
        help="comma-separated LMS server addresses",
    )
    parser.add_argument("--config", default=None,
                        help="TOML deployment file; [cluster.nodes] supplies "
                             "the server list")
    args = parser.parse_args(argv)
    servers = args.servers.split(",")
    client_opts = {}
    # Explicit --servers beats the file (same precedence as the servers).
    if args.config:
        from ..config import client_kwargs, load_config

        cfg = load_config(args.config)
        if args.servers == parser.get_default("servers"):
            servers = cfg.client_servers
        client_opts = client_kwargs(cfg)
    client = LMSClient(servers, **client_opts)
    try:
        client.discover_leader()
    except NoLeader as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)
    LMSApp(client).run()


if __name__ == "__main__":
    main()
